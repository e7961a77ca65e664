"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, 1601, 1280) [hf:meta-llama/Llama-3.2-11B-Vision]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b", kind="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, act="swiglu", rope_theta=500000.0,
    cross_attn_every=5, n_img_tokens=1601, vision_dim=1280,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, n_img_tokens=16, vision_dim=32, param_dtype="float32",
    compute_dtype="float32")

"""starcoder2-15b [dense] — GQA, RoPE [arXiv:2402.19173; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b", kind="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, act="gelu", rope_theta=100000.0,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, param_dtype="float32", compute_dtype="float32")

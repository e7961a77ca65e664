"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama3.2-3b", kind="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, act="swiglu", rope_theta=500000.0,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, param_dtype="float32", compute_dtype="float32")

"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma-2b", kind="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=256000, head_dim=256, act="geglu",
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    head_dim=16, vocab=128, param_dtype="float32", compute_dtype="float32")

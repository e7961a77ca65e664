"""minitron-8b [dense] — pruned nemotron, squared-ReLU MLP
[arXiv:2407.14679; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minitron-8b", kind="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, act="relu2",
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, param_dtype="float32", compute_dtype="float32")

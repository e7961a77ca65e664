"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]. Routed experts padded 60→64 for even 16-way
expert parallelism (padding experts receive zero routing weight —
DESIGN.md §4)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", kind="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, act="swiglu",
    n_experts=60, n_experts_padded=64, n_shared_experts=4, top_k=4,
    d_expert=1408,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=128, n_experts=6, n_experts_padded=8, n_shared_experts=2,
    top_k=2, d_expert=64, param_dtype="float32", compute_dtype="float32")

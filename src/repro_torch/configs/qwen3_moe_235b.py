"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, no shared experts
[hf:Qwen/Qwen3-30B-A3B]. bf16 optimizer states (memory-adaptive policy)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", kind="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, act="swiglu",
    n_experts=128, top_k=8, d_expert=1536, head_dim=128,
    opt_dtype="bfloat16",
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=128, n_experts=8, top_k=2, d_expert=64, head_dim=16,
    param_dtype="float32", compute_dtype="float32", opt_dtype="float32")

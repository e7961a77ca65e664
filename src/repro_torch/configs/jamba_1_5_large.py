"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]. Period-8 blocks: attention at index 3, MoE FFN on
odd indices (every 2nd layer) — reproduces 398B total / ~94B active.

bf16 optimizer states: fp32 Adam would not fit a 256-chip v5e pod
(DESIGN.md §4)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", kind="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, act="swiglu",
    n_experts=16, top_k=2, d_expert=24576,
    attn_every=8,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    opt_dtype="bfloat16",
)

REDUCED = dataclasses.replace(
    FULL, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=128, n_experts=4, top_k=2, d_expert=128,
    ssm_state=16, ssm_head_dim=16, param_dtype="float32",
    compute_dtype="float32", opt_dtype="float32", ssm_chunk=8)

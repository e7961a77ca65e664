"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-780m", kind="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, act="swiglu",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, d_model=64, vocab=128, ssm_state=16, ssm_head_dim=16,
    param_dtype="float32", compute_dtype="float32", ssm_chunk=8)

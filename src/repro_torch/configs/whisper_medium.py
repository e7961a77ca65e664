"""whisper-medium [audio] — enc-dec backbone; conv/audio frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, 1500, d_model)
[arXiv:2212.04356]. 24 encoder + 24 decoder layers; RoPE replaces the
original sinusoidal/learned positions (backbone-only reproduction,
DESIGN.md §4)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", kind="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, act="gelu", enc_seq=1500,
)

REDUCED = dataclasses.replace(
    FULL, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, enc_seq=16, param_dtype="float32",
    compute_dtype="float32")

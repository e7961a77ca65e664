"""Model/run configuration schema of the LM stack (``repro``'s
``configs/base.py``, copied: plain dataclasses).

One ``ModelConfig`` describes any of the 10 assigned architectures (dense /
MoE / SSM / hybrid / enc-dec / VLM backbones); the port runs all six
kinds (``models/transformer.py``). ``ShapeConfig`` describes the four
assigned input shapes; :func:`input_specs` gives a cell's inputs as
``meta`` tensors (``repro``'s ``ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    act: str = "swiglu"       # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    n_experts_padded: int = 0  # padded for even EP (0 -> n_experts)
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # --- hybrid (jamba): one attention layer per `attn_every` layers ---
    attn_every: int = 0
    # --- enc-dec (whisper backbone; audio frontend stubbed) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500        # precomputed frame embeddings length
    # --- VLM (llama-vision backbone; vision frontend stubbed) ---
    cross_attn_every: int = 0  # a cross-attn layer every N layers
    n_img_tokens: int = 0
    vision_dim: int = 0
    # --- compute policy ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"       # bf16 for >=100B models (DESIGN.md §4)
    remat: bool = True
    remat_policy: str = "full"       # full | dots | none  (§Perf A2)
    attn_block_q: int = 512
    attn_block_k: int = 1024
    attn_banded: bool = False        # causal-exact unrolled schedule (perf opt)
    attn_q_parallel: bool = False    # vectorized q blocks (seq-parallel attn)
    loss_chunk: int = 512
    scan_layers: bool = True

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_experts_eff(self) -> int:
        return self.n_experts_padded or self.n_experts

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds for one scan group. Dense/MoE archs scan one
        layer at a time; hybrid scans a period of attn_every layers; VLM scans
        a period of cross_attn_every."""
        if self.kind == "hybrid":
            # jamba: period-8 block, attention at index 3 (1:7 interleave),
            # MoE FFN on odd indices (every 2nd layer), dense FFN otherwise
            kinds = []
            for i in range(self.attn_every):
                attn_here = (i == 3) if self.attn_every == 8 else (
                    i == self.attn_every - 1)
                moe_here = (i % 2 == 1) and self.n_experts > 0
                if attn_here:
                    kinds.append("attn_moe" if moe_here else "attn")
                else:
                    kinds.append("mamba_moe" if moe_here else "mamba_dense")
            return tuple(kinds)
        if self.kind == "vlm":
            return tuple(
                "cross" if i == self.cross_attn_every - 1 else "self"
                for i in range(self.cross_attn_every))
        if self.kind == "ssm":
            return ("mamba",)
        if self.kind == "moe":
            return (("attn_moe_shared",) if self.n_shared_experts
                    else ("attn_moe",))
        return ("attn",)

    def n_groups(self) -> int:
        period = len(self.block_pattern())
        assert self.n_layers % period == 0, (self.name, self.n_layers, period)
        return self.n_layers // period

    def params_count(self) -> int:
        """Total parameter count: the port's ``init_params`` built on the
        ``meta`` device (shapes only, nothing allocated)."""
        from repro_torch.models import transformer
        return transformer.count_params(
            transformer.init_params(self, None, device="meta"))

    def active_params_count(self) -> int:
        """Active-per-token params (for 6·N_active·D MoE model FLOPs)."""
        from repro_torch.models import transformer
        return transformer.active_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic context — DESIGN.md §4).
SUBQUADRATIC = ("mamba2-780m", "jamba-1.5-large-398b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in SUBQUADRATIC
    return True


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta"):
    """Every model input of this cell as an empty tensor (``meta``: shapes
    and dtypes only), with ``repro``'s shapes and dtypes: ``tokens`` (and
    ``targets`` for train) ``(B, S)`` int32; decode one new token against
    a ``seq_len``-deep cache (``tokens`` ``(B, 1)``, ``position`` ``(B,)``);
    the stub ``enc_embed`` / ``img_embed`` in the compute dtype, except at
    decode (which reads the cached cross projections)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = getattr(torch, cfg.compute_dtype)
    e = lambda shp, dt: torch.empty(shp, dtype=dt, device=device)
    specs = {}
    if shape.mode == "train":
        specs["tokens"] = e((B, S), i32)
        specs["targets"] = e((B, S), i32)
    elif shape.mode == "prefill":
        specs["tokens"] = e((B, S), i32)
    else:
        specs["tokens"] = e((B, 1), i32)
        specs["position"] = e((B,), i32)
    if shape.mode != "decode":
        if cfg.kind == "encdec":
            specs["enc_embed"] = e((B, cfg.enc_seq, cfg.d_model), f)
        if cfg.kind == "vlm":
            specs["img_embed"] = e((B, cfg.n_img_tokens, cfg.vision_dim), f)
    return specs

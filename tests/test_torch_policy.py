"""Rules of the port: repro_torch and chip_smoke.py import neither jax nor
repro; importing repro_torch needs no CUDA; asking for the card where there
is none raises instead of falling back to the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
REPRO = re.compile(r"\brepro\b(?!_torch)")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    for mod in _imported_modules(path):
        assert not REPRO.search(mod), f"{path}: imports {mod}"
        assert mod.split(".")[0] != "jax", f"{path}: imports {mod}"


@pytest.mark.parametrize("path", [p for p in PORT_FILES
                                  if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_collectives_only_from_runtime(path):
    """core/runtime.py's rule: the port takes every collective from
    runtime, never from torch.distributed directly."""
    if path == ROOT / "src" / "repro_torch" / "core" / "runtime.py":
        return
    text = path.read_text()
    assert "torch.distributed" not in text, path
    for mod in _imported_modules(path):
        assert not mod.startswith("torch.distributed"), (path, mod)


def test_port_imports_without_jax_or_cuda():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_cuda_requested_without_card_raises(monkeypatch):
    from repro_torch.apps import md
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        md.init_particles(md.MDConfig(n_per_side=3), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        md.run(md.MDConfig(n_per_side=3), 1)       # cfg.device = "cuda"


def test_cuda_backend_on_cpu_tensors_raises():
    from repro_torch.apps import md
    from repro_torch.core import cell_list as CL
    from repro_torch.core import interactions as I
    cfg = md.MDConfig(n_per_side=4, device="cpu")
    ps = md.init_particles(cfg)
    cl = CL.build_cell_list(ps, **md._cl_kw(cfg))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        I.apply_pair_kernel(ps, cl, md.lj_pair_body(0.1, 1.0),
                            out={"f": "radial"}, r_cut=0.3, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        md.compute_forces(ps, md.MDConfig(n_per_side=4, device="cpu",
                                          backend="cuda"))
    with pytest.raises(ValueError, match="unknown backend"):
        I.apply_pair_kernel(ps, cl, md.lj_pair_body(0.1, 1.0),
                            out={"f": "radial"}, r_cut=0.3, backend="jnp")


def test_vortex_cuda_requested_without_card_raises(monkeypatch):
    from repro_torch.apps import vortex
    from repro_torch import convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = vortex.VortexConfig(shape=(8, 8, 8), lengths=(2.0, 2.0, 2.0))
    with pytest.raises(RuntimeError, match="cuda"):
        vortex.run(cfg, 1)                         # cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        vortex.init_ring(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.field_from_numpy(np.zeros((2, 2, 2, 3), np.float32))


def test_m4_cuda_backend_on_cpu_tensors_raises():
    from repro_torch.apps import vortex
    from repro_torch.kernels.m4_interp import ops as M4
    kw = dict(shape=(8, 8, 8), box_lo=(0.0,) * 3, box_hi=(1.0,) * 3,
              periodic=(True,) * 3)
    x = torch.rand(20, 3)
    valid = torch.ones(20, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        M4.p2m(x, torch.ones(20), valid, backend="cuda", **kw)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        M4.m2p(torch.zeros(8, 8, 8, 3), x, valid, backend="cuda", **kw)
    cfg = vortex.VortexConfig(shape=(8, 8, 8), lengths=(2.0, 2.0, 2.0),
                              device="cpu", backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        vortex.run(cfg, 1)


def test_sph_dem_cuda_requested_without_card_raises(monkeypatch):
    from repro_torch.apps import dem, sph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scfg = sph.SPHConfig(dp=0.05, box=(1.0, 0.5), fluid=(0.25, 0.25))
    dcfg = dem.DEMConfig(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5))
    assert scfg.device == dcfg.device == "cuda"
    for fn in (lambda: sph.init_dam_break(scfg), lambda: sph.run(scfg, 1),
               lambda: dem.init_block(dcfg), lambda: dem.run(dcfg, 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


def test_sph_dem_cuda_backend_on_cpu_tensors_raises():
    from repro_torch.apps import dem, sph
    scfg = sph.SPHConfig(dp=0.05, box=(1.0, 0.5), fluid=(0.25, 0.25),
                         device="cpu", backend="cuda")
    ps = sph.init_dam_break(scfg)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        sph.compute_rates(ps, scfg)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        sph.sph_step(ps, scfg)
    dcfg = dem.DEMConfig(box=(2.0, 0.6, 1.0), fill=(0.8, 0.66, 0.5),
                         device="cpu", backend="cuda")
    ps = dem.init_block(dcfg)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dem.normal_forces(ps, dcfg, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dem.dem_step(ps, dcfg)


def test_new_modules_are_checked_for_imports():
    """The slice's modules are among the files the import rule covers."""
    rel_paths = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("apps/sph.py", "apps/dem.py", "kernels/sph_forces/ops.py",
                "kernels/sph_forces/ref.py",
                "kernels/sph_forces/sph_forces.py"):
        assert f"src/repro_torch/{mod}" in rel_paths, mod


def test_lm_modules_are_checked_for_imports():
    """The LM slice's modules are among the files the import rule covers."""
    rel_paths = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("configs/base.py", "configs/registry.py",
                "configs/starcoder2_15b.py", "models/layers.py",
                "models/transformer.py", "training/serve.py",
                "training/optimizer.py", "training/train.py",
                "training/data.py", "launch/train.py",
                "sharding/specs.py", "launch/mesh.py", "launch/dryrun.py",
                "launch/cost_analysis.py",
                "kernels/flash_attention/flash_attention.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py"):
        assert f"src/repro_torch/{mod}" in rel_paths, mod


PORTED_KINDS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-780m",
                "jamba-1.5-large-398b", "whisper-medium",
                "llama-3.2-vision-11b")


@pytest.mark.parametrize("arch", PORTED_KINDS)
def test_lm_kinds_ported_run(arch):
    """The moe, ssm, hybrid, encdec and vlm kinds (ROADMAP A16b, A16c,
    A16d) build, count and run a forward on the CPU (encdec and vlm with
    their stub embeddings); their caches build."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.training import serve as S
    cfg = registry.get_config(arch, reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = S.stub_embeddings(cfg, {"tokens": torch.zeros(
        1, 4, dtype=torch.int64)})
    h, _, _ = T.forward(params, batch, cfg)
    assert h.shape == (1, 4, cfg.d_model) and bool(torch.isfinite(h).all())
    assert T.init_caches(cfg, 1, 8, device="cpu")["blocks"]
    assert cfg.params_count() == T.count_params(params)


def test_lm_sharding_ctx_raises():
    """A ctx that is not a ShardingContext raises TypeError at every LM
    entry point; a ShardingContext on a 1 × 1 gloo mesh serves as no ctx
    does (tests/test_torch_dist_lm.py holds the 4-rank meshes)."""
    from repro_torch.configs import registry
    from repro_torch.core import runtime as RT
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as SP
    from repro_torch.training import serve as S
    cfg = registry.get_config("starcoder2-15b", reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 4),
                         generator=torch.Generator().manual_seed(1))
    ctx = object()
    for fn in (lambda: T.forward(params, {"tokens": toks}, cfg, ctx),
               lambda: T.init_caches(cfg, 2, 8, ctx, device="cpu"),
               lambda: S.make_prefill_step(cfg, 8, ctx),
               lambda: S.make_decode_step(cfg, ctx),
               lambda: S.greedy_generate(cfg, params, toks, 2, 8, ctx)):
        with pytest.raises(TypeError, match="ShardingContext"):
            fn()
    mesh = RT.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    sctx = SP.ShardingContext.create(mesh)
    assert T.init_caches(cfg, 2, 8, sctx, device="cpu")["blocks"]["b0"][
        "attn"]["k"].shape == (cfg.n_groups(), 2, 8, cfg.n_kv_heads, cfg.hd)
    with torch.no_grad():
        got = S.greedy_generate(cfg, params, toks, 4, 8, sctx)
        want = S.greedy_generate(cfg, params, toks, 4, 8)
    assert torch.equal(got, want)


def test_lm_cuda_backend_and_device_without_card_raise(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.training import serve as S
    cfg = registry.get_config("starcoder2-15b", reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompt = torch.zeros(2, 12, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        S.greedy_generate(cfg, params, prompt, 2, 16, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        S.greedy_generate(cfg, params, prompt[:, :4], 2, 16,
                          backend="cuda")     # no kernel route either
    with pytest.raises(ValueError, match="unknown backend"):
        T.forward(params, {"tokens": prompt}, cfg, backend="pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_caches(cfg, 2, 16)              # device defaults to the card
    with pytest.raises(ValueError, match="Generator"):
        T.init_params(cfg, None, device="cpu")


def test_library_name_keys_source_and_flags(monkeypatch):
    """Every source builds with the common flags alone, into a library
    named by its stem and a hash of its text and those flags, so a change
    of either rebuilds (B5 takes the driver's tensor-map encoder through
    the runtime and links nothing more)."""
    from repro_torch.kernels import _build
    names = {src: _build.lib_path(src) for src in _build.sources()}
    assert {src.stem for src in names} == {"cell_pair", "flash_attention",
                                          "m4_interp", "stencil7"}
    for src, lib in names.items():
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
        assert lib.stem.startswith(src.stem + "-")
    assert len(set(names.values())) == len(names)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert all(_build.lib_path(src) != lib for src, lib in names.items())

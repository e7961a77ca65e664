"""The sharded LM stack on 4 gloo ranks (tests/_torch_dist.py's
``lm_shard`` body, one launch for the module, one thread a rank),
against the port's unsharded run in this process and, for the dense and
moe kinds, against repro's forward under a ShardingContext on 4 forced
host devices (one repro subprocess, ``repro_lm_reference``).

Serving: every kind at REDUCED in fp32 on meshes (1, 4) and (2, 2) of
``("data", "model")``, under the dry-run's rules of a prefill cell and of
a decode cell: the one-shot forward's logits, the prefill's, each decode
step's, and the greedy tokens (seeded stubs, and ``greedy_generate``'s
zero stubs). gemma-2b (MQA) and llama3.2-3b put the KV cache's rows on
"model" at decode, and the 14 positions cross the 4-row shards.
qwen2-moe's FFN goes through ``moe_map_local`` with nothing dropped.
Training: one step of the dense and moe kinds on (2, 2) with FSDP
weights: the gathered gradients, the AdamW update from the same
gradients, the global norm and the loss; and llama3.2-3b's step with
repro's sequence-parallel attention (``attn_q_parallel``, the queries
split over "model" by an ``attn_seq`` rule) on (1, 4), and its prefill on
the card's route (B5 on each rank's rows at their offset)."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist as TD
from benchmarks.xla_env import ensure_forced_host_devices

WORLD = 4
SERVE_TOL = 1e-5     # logits, fp32, sharded against unsharded
REPRO_TOL = 1e-4     # against repro's ctx forward (its jnp-vs-Pallas tol)
GRAD_TOL = 1e-5      # of the max-abs gradient
UPDATE_TOL = 1e-6    # parameters after one AdamW update
TAGS = tuple("x".join(map(str, m)) for m in TD.LM_MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    ref = tmp / "repro_lm.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    ensure_forced_host_devices(env)
    env["PYTHONPATH"] = str(TD.ROOT / "src")
    child = subprocess.Popen(
        [sys.executable, TD.__file__, "--repro-lm", str(ref)], env=env,
        cwd=TD.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        got = TD.run_ranks("lm_shard", WORLD, tmp, timeout=240,
                           archs=list(TD.LM_ARCHS),
                           meshes=[list(m) for m in TD.LM_MESHES])
    finally:
        log, _ = child.communicate(timeout=300)
    assert child.returncode == 0, log[-3000:]
    with np.load(ref) as z:
        repro = {k: z[k] for k in z.files}
    return repro, got


@functools.lru_cache(maxsize=None)
def _unsharded(arch):
    cfg, params, prompt, stubs, train = TD.lm_case(arch)
    serve = TD.lm_serve_run(cfg, params, prompt, stubs)
    tr = None
    if arch in TD.LM_TRAIN:
        from repro_torch.training import train as TTR
        _, grads = TTR.make_grad_fn(cfg)(params, train)
        tr = TD.lm_train_run(cfg, params, train, grads=grads)
    return serve, tr


def _same_on_every_rank(got, key):
    for r in got[1:]:
        np.testing.assert_array_equal(r[key], got[0][key], err_msg=key)
    return got[0][key]


@pytest.mark.parametrize("mode", ("prefill", "decode"))
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", TD.LM_ARCHS)
def test_sharded_serve_matches_unsharded(runs, arch, tag, mode):
    _, got = runs
    ref, _ = _unsharded(arch)
    for name in ("fwd", "pre", "dec"):
        key = f"serve/{arch}/{tag}/{mode}/{name}"
        err = float(np.abs(_same_on_every_rank(got, key) - ref[name]).max())
        assert err <= SERVE_TOL, (key, err)
    for name in ("tok", "gen"):
        key = f"serve/{arch}/{tag}/{mode}/{name}"
        np.testing.assert_array_equal(_same_on_every_rank(got, key),
                                      ref[name], err_msg=key)


@pytest.mark.parametrize("arch", ("gemma-2b", "llama3.2-3b"))
def test_decode_rules_shard_the_cache_rows_across_the_steps(arch):
    """At tp 4 the decode rules put the KV cache's rows on "model"
    (gemma: 1 KV head, llama: 2), and the positions the serve test writes
    run past the first shard."""
    from repro_torch.core import runtime as RT
    from repro_torch.models import transformer as TT
    cfg = TD.lm_case(arch)[0]
    ctx = TD.lm_ctx(cfg, RT.make_dry_mesh((1, 4), TD.LM_AXES), "decode",
                    TD.LM_SMAX)
    spec = TT.cache_specs(cfg, ctx, TD.LM_B, TD.LM_SMAX)["blocks"]["b0"]
    assert spec["attn"]["k"] == (None, "data", "model", None, None)
    rows = TD.LM_SMAX // 4
    assert TD.LM_S + TD.LM_NEW - 1 > 2 * rows


@pytest.mark.parametrize("tag", TAGS)
def test_moe_takes_the_map_path_and_drops_nothing(runs, tag):
    _, got = runs
    for mode in ("prefill", "decode"):
        assert int(got[0][f"moe/{tag}/{mode}/calls"]) > 0
        for r in got:
            assert int(r[f"moe/{tag}/{mode}/dropped"]) == 0


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", TD.LM_TRAIN)
def test_sharded_forward_matches_repro_ctx_forward(runs, arch, tag):
    repro, got = runs
    port = _same_on_every_rank(got, f"serve/{arch}/{tag}/prefill/fwd")
    err = float(np.abs(port - repro[f"{arch}/{tag}"]).max())
    assert err <= REPRO_TOL, err


@pytest.mark.parametrize("arch", TD.LM_TRAIN)
def test_sharded_gradients_match_unsharded(runs, arch):
    _, got = runs
    _, ref = _unsharded(arch)
    gkeys = [k for k in ref if k.startswith("g")]
    scale = max(float(np.abs(ref[k]).max()) for k in gkeys)
    for k in gkeys:
        g = _same_on_every_rank(got, f"train/{arch}/{k}")
        assert float(np.abs(g - ref[k]).max()) <= GRAD_TOL * scale, k
    for k in ("loss", "step_loss"):
        assert abs(float(got[0][f"train/{arch}/{k}"]) - float(ref[k])) \
            <= 1e-6 * max(1.0, abs(float(ref[k]))), k


@pytest.mark.parametrize("arch", TD.LM_TRAIN)
def test_sharded_adamw_update_matches_unsharded(runs, arch):
    """Clip and one AdamW update from the same gradients: the moments are
    local, the norm sums each element once."""
    _, got = runs
    _, ref = _unsharded(arch)
    ukeys = [k for k in ref if k.startswith("u")]
    for k in ukeys:
        if k == "u_norm":
            continue
        p = _same_on_every_rank(got, f"train/{arch}/{k}")
        assert float(np.abs(p - ref[k]).max()) <= UPDATE_TOL, k
    assert abs(float(got[0][f"train/{arch}/u_norm"]) - float(ref["u_norm"])) \
        <= 1e-6 * float(ref["u_norm"])


@pytest.mark.parametrize("arch", TD.LM_TRAIN)
def test_sharded_train_step_global_norm(runs, arch):
    """The train step's gradient norm (before clipping) is the unsharded
    one, and every rank reports it."""
    _, got = runs
    _, ref = _unsharded(arch)
    norm = _same_on_every_rank(got, f"train/{arch}/grad_norm")
    assert abs(float(norm) - float(ref["grad_norm"])) \
        <= 1e-6 * float(ref["grad_norm"])


def test_sequence_parallel_attention_matches_unsharded(runs):
    """repro's attn_q_parallel schedule with the queries over "model":
    the loss and gradients of one step equal the unsharded ones."""
    _, got = runs
    _, ref = _unsharded(TD.LM_TRAIN[0])
    gkeys = [k for k in ref if k.startswith("g")]
    scale = max(float(np.abs(ref[k]).max()) for k in gkeys)
    for k in gkeys:
        g = _same_on_every_rank(got, f"qpar/{k}")
        assert float(np.abs(g - ref[k]).max()) <= GRAD_TOL * scale, k
    assert abs(float(got[0]["qpar/loss"]) - float(ref["loss"])) <= 1e-6 * \
        max(1.0, abs(float(ref["loss"])))


def test_sequence_parallel_prefill_takes_b5_at_its_rows(runs):
    """The same schedule's prefill with the layer's backend forced to
    "cuda" (B5's plain version on these CPU tensors): every attention
    layer launches B5 once a rank, causal, on the rank's LM_TRAIN_S / 4
    query rows with ``q_offset`` at their first position, and the last
    logits equal the unsharded prefill's."""
    import dataclasses
    import torch
    from repro_torch.training import serve as S
    _, got = runs
    cfg, params, _, _, batch = TD.lm_case(TD.LM_TRAIN[0])
    qcfg = dataclasses.replace(cfg, attn_q_parallel=True, attn_block_q=4)
    with torch.no_grad():
        ref, _ = S.make_prefill_step(qcfg, TD.LM_SMAX)(
            params, {"tokens": batch["tokens"]})
    n = TD.LM_TRAIN_S // WORLD
    for rank, r in enumerate(got):
        want = [[1, rank * n, n]] * qcfg.n_layers
        np.testing.assert_array_equal(r["qpar/b5"], np.array(want))
    pre = _same_on_every_rank(got, "qpar/pre")
    assert float(np.abs(pre - ref.numpy()).max()) <= SERVE_TOL

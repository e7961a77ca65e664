"""The training loop around repro_torch's step on the CPU: the hybrid
kind's loss and gradients against ``jax.value_and_grad`` of repro's
(jamba-1.5-large REDUCED, 1e-4 of the max-abs gradient; JAX takes ~14 s
to lower and compile it, so it sits here, beside the launcher's
subprocesses, to balance this file's time with tests/test_torch_train.py);
the synthetic stream (a pure function of ``(seed, step)``, the bigram
kick's share) and ``memmap_batches`` (repro's exactly); the launcher in
subprocesses (the loss falls; a run killed by ``--simulate-failure`` and
resumed ends with the parameters of an uninterrupted run); and two faults
of the port: B5 under autograd (C9) and a half-written checkpoint
(C10)."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_bridge import np_
from _torch_train_cases import check_loss_and_grads

from repro.training import data as JD
from repro_torch.configs import registry as TR
from repro_torch.io import checkpoint as CK
from repro_torch.models import transformer as TT
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_hybrid_loss_and_grads_match_repro():
    check_loss_and_grads("jamba-1.5-large-398b")


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_synthetic_batch_is_a_pure_function_of_seed_and_step():
    cfg = TD.DataConfig(vocab=97, seq_len=24, global_batch=3, seed=5)
    first = [TD.synthetic_batch(cfg, s, device="cpu") for s in (0, 1, 2)]
    again = [TD.synthetic_batch(cfg, s, device="cpu") for s in (2, 0, 1)]
    for want, got in zip(first, [again[1], again[2], again[0]]):
        for k in ("tokens", "targets"):
            assert torch.equal(want[k], got[k])
    b = first[0]
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (3, 24)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 97
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    other = TD.synthetic_batch(dataclasses.replace(cfg, seed=6), 0,
                               device="cpu")
    assert not torch.equal(other["tokens"], b["tokens"])
    it = TD.synthetic_batches(cfg, start_step=1, device="cpu")
    assert torch.equal(next(it)["tokens"], first[1]["tokens"])


def test_synthetic_batch_kick_share():
    """The bigram kick rewrites half the positions (0.5 ± 0.05) and the
    rewritten tokens are (prev·7 + 3) % V of the unigram before them."""
    cfg = TD.DataConfig(vocab=1000, seq_len=255, global_batch=32, seed=0)
    toks, kick = TD._draw(cfg, 7)
    assert abs(float(kick.float().mean()) - TD.KICK_P) <= 0.05
    b = TD.synthetic_batch(cfg, 7, device="cpu")
    full = torch.cat([b["tokens"], b["targets"][:, -1:]], dim=1).long()
    kicked = kick[:, 1:]
    want = (toks[:, :-1] * 7 + 3) % cfg.vocab
    assert torch.equal(full[:, 1:][kicked], want[kicked])
    assert torch.equal(full[:, 1:][~kicked], toks[:, 1:][~kicked])
    # Zipfian: token 0 is about twice as common as token 1 among unigrams
    n0, n1 = int((toks == 0).sum()), int((toks == 1).sum())
    assert 1.6 < n0 / n1 < 2.4


def test_memmap_batches_match_repro(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "tokens.bin"
    rng.integers(0, 60000, 3 * 4 * 17 + 5).astype(np.uint16).tofile(path)
    cfg = TD.DataConfig(vocab=60000, seq_len=16, global_batch=4)
    jcfg = JD.DataConfig(**dataclasses.asdict(cfg))
    for start in (0, 2):                      # step 3 wraps to slice 0
        jit_ = JD.memmap_batches(str(path), jcfg, start_step=start)
        tit = TD.memmap_batches(str(path), cfg, start_step=start,
                                device="cpu")
        for _ in range(3):
            jb, tb = next(jit_), next(tit)
            for k in ("tokens", "targets"):
                assert tb[k].dtype == torch.int32
                np.testing.assert_array_equal(np_(tb[k]), np.asarray(jb[k]))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
          "--steps", "10", "--batch", "4", "--seq", "32", "--lr", "3e-3",
          "--ckpt-every", "2", "--log-every", "1"]


def _launch(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--ckpt-dir", str(ckpt), *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=120)
    return proc.returncode, out


def test_launcher_loss_falls_and_resume_is_exact(tmp_path):
    """An uninterrupted 10-step run beside one killed after step 5 (exit
    42) and resumed from its newest checkpoint: the loss falls, and both
    end with the same parameters and optimizer state, bit for bit."""
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    runs = [_launch(whole), _launch(broken, "--simulate-failure", "5")]
    (rc_w, out_w), (rc_b, out_b) = [_finish(p) for p in runs]
    assert rc_w == 0, out_w
    assert rc_b == 42 and "dying at step 5" in out_b, out_b
    rc_r, out_r = _finish(_launch(broken))
    assert rc_r == 0 and "[restore] resumed" in out_r, out_r
    losses = [float(line.split()[3]) for line in out_w.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 10 and losses[-1] < losses[0], losses
    cfg = TR.get_config("llama3.2-3b", reduced=True)
    example = TT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    example = {"params": example, "opt": TO.init_opt_state(
        example, TO.OptConfig())}
    a, step_a, _ = CK.load(CK.latest_step(whole), example)
    b, step_b, _ = CK.load(CK.latest_step(broken), example)
    assert step_a == step_b == 10
    for x, y in zip(TT.leaves(a), TT.leaves(b)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# faults of the port (ROADMAP C9, C10)
# --------------------------------------------------------------------------

def test_flash_attention_raises_under_grad():
    """C9: B5 has no backward. Asked to launch on tensors that require
    grad it raises RuntimeError naming backend="torch" before anything
    is built (no nvcc here: a build would fail otherwise)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    q = torch.zeros(1, 2, 16, 8, requires_grad=True)
    k = torch.zeros(1, 2, 16, 8)
    n0 = FA.LAUNCHES
    with pytest.raises(RuntimeError, match="forward only.*backend=\"torch\""):
        FA._launch(q, k, k, True)
    # with no grad to carry, the guard lets the call on to the shape checks
    bad = torch.zeros(1, 2, 16, 7)
    with pytest.raises(ValueError, match="head dim"):
        FA._launch(bad, bad, bad, True)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        FA._launch(bad.requires_grad_(), bad, bad, True)
    assert FA.LAUNCHES == n0


def test_latest_step_skips_a_half_written_checkpoint(tmp_path):
    """C10: a process that dies while an async save writes leaves
    ``step_*.tmp``; resuming must take the newest published step, not the
    partial one (repro's latest_step returns it, and its load fails)."""
    CK.save(tmp_path / "step_00000002", {"x": torch.ones(3)}, step=2)
    (tmp_path / "step_00000004.tmp").mkdir()
    (tmp_path / "step_00000004.tmp" / "leaf_00000.npy").write_bytes(b"")
    (tmp_path / "step_00000006").mkdir()            # no manifest
    assert CK.latest_step(tmp_path) == tmp_path / "step_00000002"
    tree, step, _ = CK.load(CK.latest_step(tmp_path), {"x": torch.zeros(3)})
    assert step == 2 and torch.equal(tree["x"], torch.ones(3))

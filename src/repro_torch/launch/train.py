"""The fault-tolerant training launcher (``repro``'s ``launch/train.py``):
one process, one device, no mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir <dir>

It runs on the card unless ``--device cpu``. The fault-tolerance loop:
  * a checkpoint every ``--ckpt-every`` steps under ``--ckpt-dir``
    (``io.checkpoint``: async, published by an atomic rename);
  * on start, resume from the newest complete checkpoint there;
  * the data is a pure function of the step (``training/data.py``), so a
    resumed run sees the batches an uninterrupted one would;
  * ``--simulate-failure N`` ends the process with exit code 42 right
    after step N, before that step's checkpoint, to exercise the restart.
Nothing is written unless ``--ckpt-dir`` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import registry
from repro_torch.core.particles import resolve_device
from repro_torch.io import checkpoint as CK
from repro_torch.models import transformer as T
from repro_torch.training import data as DATA
from repro_torch.training import optimizer as O
from repro_torch.training import serve as S
from repro_torch.training import train as TR

#: Exit code of ``--simulate-failure``.
FAILURE_EXIT = 42


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train an LM of the registry "
                                 "on synthetic data, with checkpoints.")
    ap.add_argument("--arch", required=True, choices=registry.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = O.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps, opt_dtype=cfg.opt_dtype)
    opt_state = O.init_opt_state(params, opt)
    step0 = 0

    if args.ckpt_dir:
        latest = CK.latest_step(args.ckpt_dir)
        if latest is not None:
            state, step0, _ = CK.load(latest, {"params": params,
                                               "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[restore] resumed from {latest} at step {step0}",
                  flush=True)

    dcfg = DATA.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    step_fn = TR.make_train_step(cfg, opt, microbatch=args.microbatch)

    _sync(dev)
    t_last, logged = time.perf_counter(), step0
    for step in range(step0, args.steps):
        batch = S.stub_embeddings(cfg, DATA.synthetic_batch(dcfg, step,
                                                            device=dev))
        params, opt_state, metrics = step_fn(params, opt_state, batch)

        if args.simulate_failure and step + 1 == args.simulate_failure:
            print(f"[failure-injection] dying at step {step + 1}",
                  flush=True)
            os._exit(FAILURE_EXIT)

        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            _sync(dev)
            dt = time.perf_counter() - t_last
            tok_s = args.batch * args.seq * (step + 1 - logged) / max(dt,
                                                                    1e-9)
            print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"{tok_s:,.0f} tok/s", flush=True)
            t_last, logged = time.perf_counter(), step + 1
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CK.save(os.path.join(args.ckpt_dir, f"step_{step + 1:08d}"),
                    {"params": params, "opt": opt_state}, step=step + 1,
                    meta={"arch": args.arch}, block=False)
    CK.wait_all()
    print("done.", flush=True)
    return params


if __name__ == "__main__":
    main()

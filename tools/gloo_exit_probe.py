"""How often a gloo rank aborts at the interpreter's exit, and whether
leaving with ``os._exit(0)`` avoids it (the multi-rank CPU tests' ranks,
``tests/_torch_dist.py``).

    python3 tools/gloo_exit_probe.py [--launches N] [--parallel P]
                                     [--exit interpreter|os_exit]

Each launch starts 4 gloo ranks on the CPU (a ``file://`` store, one
thread each), which run 30 rounds of one ``batch_isend_irecv`` batch (1
and 2 hops both ways) and an ``all_gather``, destroy their group, log
that and then leave: by the interpreter's exit, or by ``os._exit(0)``.
The last round's ops and works stay referenced from a module global, as
a rank body's mesh and runtime state stay referenced from their modules
until the interpreter exits.
``--parallel`` launches run at once, to load the host as a test suite
does. Prints each failed launch (a rank's exit code and its log) and the
count of failed launches. Needs no card.
"""
import argparse
import datetime
import os
import subprocess
import sys
import tempfile

WORLD = 4
#: What outlives the group: the last round's ops and works.
KEEP = []


def rank_main(rank: int, store: str, exit_mode: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.arange(1000, dtype=torch.float32) + rank
    for _ in range(30):
        ops = []
        for hop in (1, 2):
            for sgn in (1, -1):
                tag = len(ops)
                ops.append(dist.P2POp(dist.isend, x,
                                      (rank + sgn * hop) % WORLD, tag=tag))
                ops.append(dist.P2POp(dist.irecv, torch.empty_like(x),
                                      (rank - sgn * hop) % WORLD, tag=tag))
        works = dist.batch_isend_irecv(ops)
        for work in works:
            work.wait()
        dist.all_gather([torch.empty_like(x) for _ in range(WORLD)], x)
        KEEP[:] = [ops, works]
    dist.destroy_process_group()
    print(f"rank {rank}: group destroyed", flush=True)
    if exit_mode == "os_exit":
        os._exit(0)


def launch(exit_mode: str):
    """Start one launch's ranks; returns (directory, [(process, log)])."""
    d = tempfile.mkdtemp(prefix="gloo_exit_")
    procs = []
    for r in range(WORLD):
        log = open(os.path.join(d, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--store",
             os.path.join(d, "store"), "--exit", exit_mode],
            stdout=log, stderr=subprocess.STDOUT), log))
    return d, procs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--exit", default="interpreter",
                    choices=("interpreter", "os_exit"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.store, args.exit)
        return 0
    failed = done = 0
    while done < args.launches:
        batch = [launch(args.exit)
                 for _ in range(min(args.parallel, args.launches - done))]
        for d, procs in batch:
            codes = []
            for p, log in procs:
                codes.append(p.wait(timeout=300))
                log.close()
            done += 1
            if any(codes):
                failed += 1
                print(f"launch {done}: exit codes {codes}")
                for r in range(WORLD):
                    with open(os.path.join(d, f"rank{r}.log")) as f:
                        print(f"  rank {r}: " + f.read().strip()
                              .replace("\n", " | "))
            for r in range(WORLD):
                os.remove(os.path.join(d, f"rank{r}.log"))
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
            os.rmdir(d)
    print(f"exit by {args.exit}: {failed} of {done} launches failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

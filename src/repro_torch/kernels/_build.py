"""Build and load the hand-written CUDA kernels.

Each ``kernels/<name>/csrc/<file>.cu`` is compiled with ``nvcc`` into its
own shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <file>.cu

(no ``--use_fast_math``: the kernels stay within the stated tolerance of
their plain PyTorch versions). Libraries go to ``build/repro_torch/`` at
the repository root, named by a hash of the source, of every local header
it includes (``#include "..."``, followed recursively) and of the flags,
so a changed source or header is rebuilt and an unchanged one is reused.
The build runs at first use; :func:`build_all` compiles every source at
once, one ``nvcc`` process per source, all started together, and keeps
each one's seconds in :data:`BUILD_SECONDS`. ``ptxas``'s report of
registers and shared memory is kept beside each library as ``<lib>.log``.

A failed build raises :class:`RuntimeError` with nvcc's stderr. Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Wall seconds of each source's nvcc in this process's builds, {source:
#: seconds} (a source whose library was already built is not listed).
BUILD_SECONDS: Dict[pathlib.Path, float] = {}

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources() -> List[pathlib.Path]:
    """Every CUDA source of the package, ``kernels/**/csrc/*.cu``."""
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def local_headers(src: pathlib.Path) -> List[pathlib.Path]:
    """The headers that ``src`` includes with ``#include "..."``, each
    resolved against the folder of the file that includes it, followed
    recursively; each once, in the order first reached."""
    seen: List[pathlib.Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(path.read_text()):
            header = (path.parent / name).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def lib_path(src: pathlib.Path) -> pathlib.Path:
    """Where the library of ``src`` lives: keyed by the text of the source
    and of its local headers, and by the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(srcs: List[pathlib.Path] | None = None
              ) -> Dict[pathlib.Path, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: library path}. Raises RuntimeError naming each failed
    source with nvcc's stderr."""
    srcs = sources() if srcs is None else list(srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {src: lib_path(src) for src in srcs}
    todo = [src for src in srcs if not out[src].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        tmp = out[src].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    results = {}

    def wait(src, proc):
        # each process's pipes are drained by its own thread, so the time
        # it finished is its own
        results[src] = proc.communicate()
        BUILD_SECONDS[src] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(src, proc))
               for src, _, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    errors = []
    for src, tmp, proc in procs:
        stdout, stderr = results[src]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stderr}{stdout}")
            continue
        out[src].with_suffix(".log").write_text(stderr + stdout)
        os.replace(tmp, out[src])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load(src: pathlib.Path) -> ctypes.CDLL:
    """Build ``src`` if needed and load its library (once per process)."""
    return ctypes.CDLL(str(build_all([src])[src]))


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Elastic checkpoint/restart (port of ``repro.io.checkpoint``; paper §3.7,
HDF5 analogue).

Checkpoints are whole logical arrays written as ``.npy`` files with a JSON
manifest, in ``repro``'s format, so either package reads what the other
wrote: leaf names are ``jax.tree_util.keystr`` paths (``['x']``,
``['props']['v']``; :mod:`repro_torch.tree`), leaves are listed in
flattening order, bf16 is stored as its ``uint16`` bits under the dtype
name ``"bfloat16"``, and each file carries the first 16 hex digits of its
sha256. The manifest's ``treedef`` is free text that no loader parses.

  * atomic publish — data goes into ``<dir>.tmp``, which is renamed over
    the target; a crash mid-write never corrupts the last good checkpoint;
  * manifest-validated — shapes and digests are checked on load;
  * async — ``save(..., block=False)`` copies every leaf to the host
    first, then hands the write to a thread; the next save of the same
    path, :func:`flush` or :func:`async_writes` joins it;
  * elastic — :func:`load_particles` re-pads the stored valid rows to a
    new capacity (slot layout is not part of the format).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.particles import ParticleSet, from_positions, \
    resolve_device

_PENDING: Dict[str, threading.Thread] = {}

#: Dtypes numpy lacks, stored as raw integer views (``repro``'s table).
_NUMPY_SAFE = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
               "float8_e5m2": np.uint8}
_TORCH_VIEW = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": getattr(torch, "float8_e4m3fn", None),
               "float8_e5m2": getattr(torch, "float8_e5m2", None)}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to store, logical dtype name) of one leaf: a tensor on
    any device, a numpy array or a number — always copied, so a later
    in-place write to the leaf cannot reach an async save."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if name in _NUMPY_SAFE:
            bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                                       else torch.int8)
            return bits.numpy().view(_NUMPY_SAFE[name]), name
        return t.numpy(), name
    arr = np.array(leaf, copy=True)
    name = str(arr.dtype)
    if name in _NUMPY_SAFE:
        return arr.view(_NUMPY_SAFE[name]), name
    return arr, name


def _from_stored(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a CPU tensor of its logical dtype."""
    # (np.ascontiguousarray would turn a 0-d array into a 1-d one)
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if dtype_name in _NUMPY_SAFE:
        signed = torch.int16 if arr.itemsize == 2 else torch.int8
        t = t.view(signed).view(_TORCH_VIEW[dtype_name])
    return t


def _digest(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


def save(path, tree, *, step: int = 0, meta: Optional[Dict] = None,
         block: bool = True) -> None:
    """Write a checkpoint of ``tree`` (dicts, lists, tuples, dataclasses
    of tensors or arrays) at ``path``, a directory. Every leaf is copied
    to the host before this returns, also with ``block=False``."""
    path = pathlib.Path(path)
    pairs, treedef = T.flatten_with_path(tree)
    host = [(name, *_to_host(leaf)) for name, leaf in pairs]

    def write():
        tmp = path.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta or {},
                    "treedef": str(treedef), "leaves": []}
        for i, (name, stored, dtype_name) in enumerate(host):
            fn = f"leaf_{i:05d}.npy"
            np.save(tmp / fn, stored)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(stored.shape),
                "dtype": dtype_name, "sha256_16": _digest(tmp / fn)})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)

    key = str(path)
    prev = _PENDING.pop(key, None)
    if prev is not None:
        prev.join()
    if block:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING[key] = t


def wait_all() -> None:
    """Join every pending async write."""
    for t in list(_PENDING.values()):
        t.join()
    _PENDING.clear()


def flush(path=None) -> None:
    """Join pending async writes — all of them, or just ``path``'s. After
    ``flush()`` every ``save(..., block=False)`` issued so far has
    published atomically: no ``.tmp`` is left behind."""
    if path is not None:
        t = _PENDING.pop(str(pathlib.Path(path)), None)
        if t is not None:
            t.join()
        return
    wait_all()


@contextlib.contextmanager
def async_writes() -> Iterator[None]:
    """Scope async checkpointing: on exit (an exception included) every
    pending writer thread is joined."""
    try:
        yield
    finally:
        flush()


def _read_leaves(path: pathlib.Path):
    """(manifest, [(entry, CPU tensor)]) with every digest and shape
    checked."""
    manifest = json.loads((path / "manifest.json").read_text())
    out = []
    for entry in manifest["leaves"]:
        f = path / entry["file"]
        if _digest(f) != entry["sha256_16"]:
            raise IOError(f"checkpoint chunk {entry['file']} corrupt")
        arr = np.load(f)
        if list(arr.shape) != entry["shape"]:
            raise IOError(f"shape mismatch in {entry['file']}")
        out.append((entry, _from_stored(arr, entry["dtype"])))
    return manifest, out


def load(path, example_tree) -> Tuple[Any, int, Dict]:
    """Load a checkpoint into the structure of ``example_tree``. Each
    leaf comes back as a tensor of the stored dtype, on the device of the
    example's leaf where that is a tensor, else on the CPU. Returns
    ``(tree, step, meta)``."""
    path = pathlib.Path(path)
    manifest, stored = _read_leaves(path)
    ex_leaves, treedef = T.flatten(example_tree)
    if len(ex_leaves) != len(stored):
        raise IOError(f"checkpoint has {len(stored)} leaves; expected "
                      f"{len(ex_leaves)}")
    leaves = [t.to(ex.device) if isinstance(ex, torch.Tensor) else t
              for ex, (_, t) in zip(ex_leaves, stored)]
    return T.unflatten(treedef, leaves), manifest["step"], manifest["meta"]


def latest_step(root) -> Optional[pathlib.Path]:
    """The newest published step directory under ``root`` (``step_%08d``
    layout). A ``step_*.tmp`` left by a process that died mid-write is
    skipped (``repro``'s would return it, and its load would fail), as is
    a directory with no manifest."""
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = sorted(p for p in root.iterdir()
                   if p.is_dir() and re.fullmatch(r"step_\d+", p.name)
                   and (p / "manifest.json").is_file())
    return steps[-1] if steps else None


# --------------------------------------------------------------------------
# ParticleSet-specific elastic helpers
# --------------------------------------------------------------------------

def save_particles(path, ps: ParticleSet, *, step: int = 0,
                   meta: Optional[Dict] = None, block: bool = True) -> None:
    """Store only the valid rows (slot layout is run-specific, not data).
    The selection runs on the particles' device; the rows are copied to
    the host before this returns."""
    valid = ps.valid
    tree = {"x": ps.x[valid],
            "props": {k: v[valid] for k, v in ps.props.items()}}
    save(path, tree, step=step,
         meta={**(meta or {}), "n": int(valid.sum())}, block=block)


def load_particles(path, *, capacity: int, device="cuda"
                   ) -> Tuple[ParticleSet, int, Dict]:
    """Elastic restart: re-pad the stored rows into a fresh set of
    ``capacity`` slots on ``device``. Returns ``(ps, step, meta)``."""
    dev = resolve_device(device)
    manifest, stored = _read_leaves(pathlib.Path(path))
    arrays = {e["name"]: t for e, t in stored}
    x = arrays["['x']"]
    props = {k[len("['props']['"):-2]: v.to(dev) for k, v in arrays.items()
             if k.startswith("['props']")}
    ps = from_positions(x.to(dev), capacity=capacity, props=props)
    return ps, manifest["step"], manifest["meta"]

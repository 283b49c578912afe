"""Fault-tolerant checkpoint store.

Port of ``repro/checkpoint/store.py``, with numpy on the host.  Layout:
``<dir>/step_<N>/`` holds one ``.npy`` per leaf of a tree (named by its
path) plus ``manifest.json`` (step, and each leaf's file, shape and dtype),
the reference's layout and names, so a checkpoint either package writes
restores in the other.  A tree is nested dicts (keys in sorted order, as
JAX orders them), named tuples and dataclasses (fields in order, as
``ParticleState`` and the block carries), lists and tuples (by index), and
tensors or numpy arrays as leaves; a None holds no leaf.

Writes are atomic: a ``.tmp-`` staging directory is renamed into place
only after every leaf and the manifest are written, so a crash mid-save
never corrupts the latest checkpoint.  :func:`restore_latest` takes the
newest complete step.  A restore places each leaf on the device of its
template leaf and never casts: a dtype or shape that differs raises.

On a device mesh (leaves that are ``DTensor``s) a save is collective:
each leaf is gathered whole on rank 0 (``shardings.gather_to_first``),
rank 0 writes, and a barrier follows; the files are the single-device
ones.  A restore places each leaf per ``shardings`` (a matching tree of
``distributed.shardings.NamedSharding``s, the *current* mesh's), or as
its template DTensor is placed: a checkpoint written on one device count
restores onto another, as the reference's ``store.py:78`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.shardings import NamedSharding, gather_to_first


def _children(node):
    """``[(name, child), ...]`` of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, NamedSharding):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in the reference's order and names."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for name, child in kids:
        flat.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return flat


def _rebuild(like, loaded: dict, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``loaded``."""
    kids = _children(like)
    if kids is None:
        return loaded[prefix]
    new = {name: _rebuild(child, loaded,
                          f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: new[str(k)] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**new)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **new)
    return type(like)(new[str(i)] for i in range(len(like)))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the newest ``keep`` steps.  With
    DTensor leaves every rank must call it: each leaf is gathered whole on
    rank 0, which writes, and every rank returns after the write."""
    flat = _flatten(tree)
    if any(isinstance(x, DTensor) for x in flat.values()):
        arrays = {key: gather_to_first(leaf) if isinstance(leaf, DTensor)
                  else _to_numpy(leaf) for key, leaf in flat.items()}
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, arrays, keep)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, flat, keep)


def _write(ckpt_dir: str, step: int, flat: dict, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": {}}
    for key, leaf in flat.items():
        arr = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    steps = sorted(available_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def available_steps(ckpt_dir: str) -> list:
    """The steps under ``ckpt_dir`` whose manifest was written, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def restore(ckpt_dir: str, step: int, like: Any, *,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like``: every leaf on its template
    leaf's device (a tensor; a numpy template restores as numpy), shape and
    dtype equal to the template's or ``ValueError``.  ``shardings``, a
    tree matching ``like`` (or a part of it, None where a leaf has none),
    places a leaf on the current mesh; a template DTensor without one is
    placed as the template is.  Every rank reads the files itself."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat_sh = _flatten(shardings) if shardings is not None else {}
    loaded = {}
    for key, ref in _flatten(like).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        arr = np.load(os.path.join(path, meta["file"]))
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {arr.shape} != {shape}")
        ref_dtype = _np_dtype(ref)
        if arr.dtype != ref_dtype:
            # a silent cast here would swallow precision (float64 tile
            # counters restored against a float32 template lose exact
            # integer adds past 2**24): a mismatch is the caller's bug
            raise ValueError(
                f"leaf {key!r}: checkpoint dtype {arr.dtype} != template "
                f"dtype {ref_dtype} (restore never casts; fix the template "
                "or re-save)")
        if not isinstance(ref, torch.Tensor):
            loaded[key] = arr
            continue
        x = torch.from_numpy(arr).to(ref.device)
        sh = flat_sh.get(key)
        if sh is None and isinstance(ref, DTensor):
            sh = NamedSharding(ref.device_mesh, ref.placements)
        loaded[key] = x if sh is None else sh.place(x)
    return _rebuild(like, loaded)


def restore_latest(ckpt_dir: str, like: Any, *, shardings: Any = None):
    """``(step, tree)`` from the newest complete checkpoint, or
    ``(None, None)``."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None, None
    return steps[-1], restore(ckpt_dir, steps[-1], like, shardings=shardings)

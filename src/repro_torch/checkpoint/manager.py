"""Fault-tolerant checkpointing: atomic writes, keep-k retention and
auto-resume (the port of ``repro.checkpoint.manager``).

Layout: <dir>/step_<n>/arrays.npz + meta.json, written to a temp dir and
renamed (rename is atomic on POSIX) so a preempted save never corrupts the
latest checkpoint. A preemption hook (SIGTERM) triggers a final save in the
launcher.

The format is the reference's: ``arrays.npz`` holds one array per leaf
under the reference's path string (a dataclass field as ``.name``, a dict
key bare, joined by ``/``: ``.params/embed/table``, ``.opt/.mu/layers/attn/wq``,
``.opt/.step``, ``.step``) and ``meta.json`` is ``{"step", "extra"}``, so a
checkpoint written by either package restores into the other.

Checkpoints are elastic. A tree of DTensors is saved by every rank of its
mesh (each leaf's ``full_tensor()`` is a collective); rank 0 writes the
whole arrays, so the file is the one a single process writes. ``restore``
with ``shardings=`` places each leaf on the mesh of the restarted job,
whatever mesh saved it; without, ``device=`` places the plain leaves.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..kernels.dispatch import resolve_device
from ..models.sharding import NamedSharding

__all__ = ["CheckpointManager"]


def _flatten_with_paths(tree, prefix=(), out=None):
    """{path string: leaf} in the reference's naming (``jax.tree_util``'s
    key paths as ``manager.py:_flatten_with_paths`` prints them). A
    ``NamedSharding`` is a leaf (of a shardings tree)."""
    out = {} if out is None else out
    if isinstance(tree, NamedSharding):
        out["/".join(prefix)] = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten_with_paths(getattr(tree, f.name), prefix + (f".{f.name}",), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_paths(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_with_paths(v, prefix + (str(i),), out)
    elif tree is not None:
        out["/".join(prefix)] = tree
    return out


def _rebuild(tree, prefix, leaf_fn):
    """``tree``'s structure with each leaf replaced by leaf_fn(path, leaf)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), prefix + (f".{f.name}",), leaf_fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (str(k),), leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (str(i),), leaf_fn) for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaf_fn("/".join(prefix), tree)


def _host_copy(key, leaf) -> np.ndarray:
    """A host copy of one leaf that no later in-place update can touch (a
    DTensor's whole value: a collective)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            raise TypeError(f"checkpoint leaf {key!r} is {leaf.dtype}, which numpy "
                            "cannot hold; cast it before saving")
        if isinstance(leaf, DTensor):
            return leaf.detach().full_tensor().cpu().numpy()
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             block: bool = False):
        """Copy every leaf to host memory before returning (the next train
        step overwrites the parameters in place); write to disk in a
        background thread unless ``block`` or ``async_save=False``. A tree
        with DTensor leaves is saved by every rank of their mesh, leaf by
        leaf; rank 0 alone keeps the arrays and writes."""
        leaves = _flatten_with_paths(tree)
        sharded = any(isinstance(v, DTensor) for v in leaves.values())
        writer = not sharded or dist.get_rank() == 0
        host = {}
        for k, v in leaves.items():
            h = _host_copy(k, v)
            if writer:
                host[k] = h
        if not writer:
            return
        meta = {"step": int(step), "extra": extra or {}}
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict):
        final = self.dir / f"step_{step:08d}"
        tmp = pathlib.Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            np.savez(tmp / "arrays.npz", **host)
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, shardings=None, device=None):
        """(tree, meta): the checkpoint in the structure of ``like`` (a tree
        of tensors, e.g. a freshly initialised ``TrainState``, or meta
        tensors; its leaves give the dtypes). With ``shardings`` (a tree of
        ``NamedSharding`` over ``like``) each leaf becomes a DTensor on that
        mesh, which need not be the mesh that saved it; every rank reads the
        file and keeps its own blocks. Otherwise each leaf lands on
        ``device`` (None -> cuda)."""
        placed = _flatten_with_paths(shardings) if shardings is not None else None
        if placed is None:
            dev = resolve_device(device)
        self.wait()
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        with np.load(d / "arrays.npz") as z:    # read leaf by leaf
            missing = [k for k in _flatten_with_paths(like) if k not in z.files]
            if missing:
                raise KeyError(f"checkpoint missing keys: {missing[:5]}...")

            def leaf(key, want):
                t = torch.from_numpy(z[key])
                if isinstance(want, torch.Tensor):
                    t = t.to(want.dtype)
                if placed is None:
                    return t.to(dev)
                sh = placed[key]
                return distribute_tensor(t.to(_mesh_device(sh.mesh)), sh.mesh, sh.placements,
                                         src_data_rank=None)

            return _rebuild(like, (), leaf), meta

    def restore_latest(self, like, **kw):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, like, **kw)

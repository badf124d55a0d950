"""Checkpointing with the reference's on-disk layout.

Counterpart of ``repro/ckpt/manager.py``; a checkpoint written by either
package restores in the other, key for key:

* **Layout**: ``step_K/arrays.npz`` holds every leaf under the reference's
  path string (``.params/embed/table``, ``.opt/.m/...``, ``.data_step``),
  and ``step_K/manifest.json`` the step, the caller's ``extra``, the keys
  and ``dtypes``: the leaves numpy cannot store (bfloat16, float8) go in
  as a same-width unsigned integer view, named there.
* **Atomic**: a checkpoint is written under ``step_K.tmp`` and renamed to
  ``step_K`` only after every array and the manifest are written, so a job
  killed mid-save never leaves a half-readable latest.
* **Async**: ``save()`` copies to host memory at once and writes to disk
  on a background thread; an error there is raised by the next
  ``wait()`` (``save`` and ``restore`` wait first).
* **Retention**: the ``keep`` newest checkpoints are retained; older ones
  are deleted only after a newer one is written.

Arrays are stored whole, so checkpoints are mesh-agnostic.  Under a mesh
(``DTensor`` leaves) every rank takes part in gathering each leaf whole and
rank 0 writes; ``wait()`` then holds every rank at a barrier until the
write is durable.  The elastic restore (``pspecs`` and ``mesh``) lays each
leaf out by its resolved spec on the mesh given, whatever plan saved it:
each rank slices its own shard out of the host array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.parallel import shardctx

# dtypes numpy can't serialize natively: stored as a same-width integer view
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}


def _to_host(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(numpy array, exotic dtype name or None) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True), None
    # a copy even on the CPU (where .cpu() is the live tensor): the next
    # step updates the state in place while the background write reads it;
    # a DTensor is gathered whole first (a collective: every rank is here)
    t = shardctx.full(leaf).detach().to("cpu", copy=True)
    name = str(t.dtype).replace("torch.", "")
    if name in _EXOTIC:
        view = _EXOTIC[name][1]
        return t.view(_SIGNED[view]).numpy().view(view), name
    return t.numpy(), None


def _from_host(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name:
        dtype, view = _EXOTIC[name]
        return torch.from_numpy(arr.view(view).view(
            np.int16 if view == np.uint16 else np.uint8)).view(dtype)
    return torch.from_numpy(arr)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False         # a mesh save not yet waited for

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write in the background (unless blocking).
        Under a mesh every rank calls it and rank 0 writes."""
        self.wait()                     # one save in flight at a time
        host, dtypes = {}, {}
        leaves = pytree.flatten_with_paths(tree)
        if any(shardctx.is_dtensor(v) for v in leaves.values()):
            self._barrier = True
            if dist.get_rank() != 0:
                for v in leaves.values():     # each gather, nothing kept
                    shardctx.full(v)
                return
        for k, v in leaves.items():
            host[k], name = _to_host(v)
            if name:
                dtypes[k] = name
        meta = {"step": step, "extra": extra or {}, "dtypes": dtypes,
                "keys": sorted(host.keys()), "time": time.time()}

        def write():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **host)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:       # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}")

    def _gc(self) -> None:
        all_steps = sorted(
            int(n.split("_", 1)[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in all_steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                pspecs: Any = None, mesh=None,
                batch_size: Optional[int] = None,
                device=None) -> Tuple[int, Any, Dict]:
        """Load (step, tree, extra).

        ``like`` gives the tree's structure and each leaf's dtype (its
        tensors may live on the ``meta`` device); leaves land on
        ``device``, else on the ``like`` leaf's device (the CPU for a meta
        leaf).  With ``pspecs`` and ``mesh`` (the elastic path) each leaf
        becomes a ``DTensor`` laid out on ``mesh`` by its resolved spec
        (shape-aware, ``batch_size`` resolving ``"batch"``).  Without
        ``like``: a flat {key: CPU tensor} dict.
        """
        if (pspecs is None) != (mesh is None):
            raise ValueError("restore: pass pspecs and mesh together")
        self.wait()
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        names = meta.get("dtypes", {})
        with np.load(os.path.join(d, "arrays.npz")) as blob:
            flat = {k: _from_host(blob[k], names.get(k)) for k in blob.files}

        if like is None:
            return step, flat, meta["extra"]

        ref = pytree.flatten_with_paths(like)
        missing = set(ref) - set(flat)
        if missing:
            raise KeyError(f"checkpoint missing arrays: {sorted(missing)[:5]}")
        specs = (pytree.flatten_with_paths(pspecs) if mesh is not None
                 else None)
        out = []
        for key, leaf in ref.items():
            dev = device if device is not None else (
                leaf.device if leaf.device.type != "meta" else "cpu")
            if specs is None:
                out.append(flat[key].to(device=dev, dtype=leaf.dtype))
            else:
                out.append(shardctx.layout(
                    flat[key].to(dtype=leaf.dtype), mesh, specs[key],
                    batch_size, device=dev))
        return step, pytree.unflatten(like, iter(out)), meta["extra"]

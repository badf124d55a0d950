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

Arrays are stored whole.  Restoring onto a device mesh (``pspecs`` and
``mesh``: the reference's elastic path) waits for ROADMAP queue 1, item 5.
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

from repro_torch import pytree

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
    # step updates the state in place while the background write reads it
    t = leaf.detach().to("cpu", copy=True)
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

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write in the background (unless blocking)."""
        self.wait()                     # one save in flight at a time
        host, dtypes = {}, {}
        for k, v in pytree.flatten_with_paths(tree).items():
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
        leaf).  Without ``like``: a flat {key: CPU tensor} dict.
        """
        if pspecs is not None or mesh is not None:
            raise NotImplementedError(
                "restoring onto a device mesh (pspecs, mesh) waits for the "
                "sharded path, ROADMAP queue 1, item 5")
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
        out = []
        for key, leaf in ref.items():
            dev = device if device is not None else (
                leaf.device if leaf.device.type != "meta" else "cpu")
            out.append(flat[key].to(device=dev, dtype=leaf.dtype))
        return step, pytree.unflatten(like, iter(out)), meta["extra"]

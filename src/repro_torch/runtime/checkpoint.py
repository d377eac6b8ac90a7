"""Checkpoints: atomic manifests, asynchronous writes, restore by key path
(twin of ``repro/runtime/checkpoint.py``).

  * A checkpoint becomes visible only when its directory is renamed into
    place, manifest and arrays written: a job killed mid-write never
    restores a torn checkpoint (a left-over ``.tmp-*`` is not listed).
  * ``save`` copies the tree to the host on the caller's thread, then
    writes on a background thread while training goes on; ``wait``
    joins it and raises what it raised.
  * Leaves are addressed by their key path (``tree.items``), so a restore
    fills any tree with the same paths, each leaf placed on the device and
    in the dtype of the target's leaf.
  * bf16 has no numpy dtype: a bf16 leaf is stored as its raw 16-bit
    words (int16) and the manifest names its dtype, so it round-trips bit
    for bit (the reference widens it to f32).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import items, unflatten

#: torch dtypes stored under another numpy dtype, by their raw bits
_RAW = {torch.bfloat16: torch.int16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(tree) -> tuple[dict, dict]:
    """({key path: numpy array}, {key path: dtype name}), every leaf
    copied off the tree's own memory (training goes on updating it)."""
    arrays, dtypes = {}, {}
    for key, leaf in items(tree):
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        dtypes[key] = _dtype_name(t.dtype)
        arrays[key] = t.view(_RAW.get(t.dtype, t.dtype)).numpy()
    return arrays, dtypes


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step:09d}")

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot ``tree`` to the host, then write and rename it on a
        background thread (one write outstanding at a time)."""
        arrays, dtypes = _to_host(tree)
        self.wait()

        def write():
            try:
                tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".tmp-{step}-")
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
                manifest = {"step": step, "time": time.time(),
                            "keys": sorted(arrays), "dtypes": dtypes,
                            "format": 1}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                os.rename(tmp, self._path(step))      # atomic visibility
                self._gc()
            except BaseException as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the outstanding write; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def list_steps(self) -> list[int]:
        return sorted(int(d.split("-")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step-") and os.path.exists(
                          os.path.join(self.dir, d, "manifest.json")))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None
                ) -> tuple[Any, int]:
        """(a tree shaped as ``target`` with the checkpoint's leaves, each
        on the device and in the dtype of the target's leaf, the step);
        the latest step unless ``step``.  Raises FileNotFoundError without
        a checkpoint, ValueError on a leaf of another shape."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, like in items(target):
                t = torch.from_numpy(data[key])
                stored = getattr(torch, dtypes[key])
                if stored in _RAW:
                    t = t.view(stored)
                if tuple(t.shape) != tuple(like.shape):
                    raise ValueError(f"{key}: checkpoint shape "
                                     f"{tuple(t.shape)}, target "
                                     f"{tuple(like.shape)}")
                leaves.append(t.to(device=like.device, dtype=like.dtype))
        return unflatten(target, leaves), step

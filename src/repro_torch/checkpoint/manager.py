"""Checkpointing: atomic, async, keep-k, verified resume (port of
``repro.checkpoint.manager``, in the same on-disk format).

  * **format**: ``<dir>/step_<10 digits>/arrays.npz``, one array per leaf
    under its tree path joined by ``//`` (dict keys, ``NamedTuple`` field
    names, ``PackedNVFP4`` field names), and ``meta.json`` with the step,
    a content digest, the metrics and the sorted keys.  bf16 and fp8
    leaves are stored as f32 (exact) and cast back on restore.  A port
    ``TrainState`` flattens to the reference's keys, so either package
    restores the other's checkpoints.
  * **atomic**: written to ``<dir>/tmp.<step>``, fsynced, then renamed.
  * **verified resume**: a checkpoint whose digest or keys do not match is
    skipped and the next newest is used.
  * **async**: the write runs on a thread; the caller pays the copy of
    the tensors to the host.
  * **keep-k**: older steps are deleted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..core.nvfp4 import PackedNVFP4

_SEP = "//"
# float types vanilla numpy lacks (the reference stores them as f32)
_NOT_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, ``NamedTuple`` and ``PackedNVFP4`` fields in declaration
    order; None has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif isinstance(tree, PackedNVFP4):
        for f in ("codes", "scales", "tensor_scale"):
            yield from _items(getattr(tree, f), prefix + (f,))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _NOT_NUMPY:
            t = t.to(torch.float32)      # exact; restore casts back
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def _digest(flat: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes()[:4096])
        h.update(str(flat[k].shape).encode())
    return h.hexdigest()[:16]


def _rebuild(like, flat: dict, prefix=()):
    """A tree of ``like``'s structure, leaves from ``flat`` in the dtypes
    and on the devices of ``like``'s leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), flat, prefix + (n,))
                             for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, prefix + (str(i),))
                          for i, v in enumerate(like))
    if isinstance(like, PackedNVFP4):
        return dataclasses.replace(like, **{
            f: _rebuild(getattr(like, f), flat, prefix + (f,))
            for f in ("codes", "scales", "tensor_scale")})
    arr = flat[_SEP.join(prefix)]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, metrics: dict | None = None) -> None:
        flat = _flatten(tree)          # the device-to-host copy, here
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, metrics or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, metrics or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, metrics: dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "digest": _digest(flat), "metrics": metrics,
                "keys": sorted(flat)}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d{10})", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _load(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def _valid(self, step: int) -> bool:
        path = os.path.join(self.dir, f"step_{step:010d}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            flat = self._load(step)
            return (_digest(flat) == meta["digest"]
                    and sorted(flat) == meta["keys"])
        except Exception:
            return False

    def latest_step(self) -> int | None:
        for s in reversed(self.all_steps()):
            if self._valid(s):
                return s
        return None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure, dtypes and devices of ``like``."""
        return _rebuild(like, self._load(step))

    def restore_latest(self, like: Any) -> tuple[int, Any] | None:
        s = self.latest_step()
        if s is None:
            return None
        return s, self.restore(s, like)

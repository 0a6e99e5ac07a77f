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
    skipped and the next newest is used.  A restore reads each array
    where it lies in the file (``_Npz``): the digest its first bytes, a
    mesh rank its own shard's.
  * **async**: the write runs on a thread; the caller pays the copy of
    the tensors to the host.
  * **keep-k**: older steps are deleted.
  * **a training mesh**: rank 0 writes the whole state, gathered from
    every rank's stored shards (``core.qad.gather_state``); every rank
    restores its own shards of it (``restore(..., cut=)``), so a mesh's
    checkpoint restores on one device and one device's on a mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import struct
import threading
import warnings
import zipfile
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


def _digest(flat) -> str:
    """The reference's digest: each key, the first 4096 bytes of its
    array in C order and its shape (read without copying the rest)."""
    h = hashlib.sha256()
    for k in sorted(flat):
        arr = flat[k]
        h.update(k.encode())
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:4096]
                 .tobytes())
        h.update(str(arr.shape).encode())
    return h.hexdigest()[:16]


class _Npz:
    """An npz's arrays by key, each read where it lies in the file: a
    member stored uncompressed (``np.savez``'s) is a read-only memmap, so
    a rank that cuts its shard reads the shard's bytes alone, and the
    digest its first 4096 bytes; any other member is loaded."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self._names = {n[:-4]: n for n in self._zip.namelist()
                       if n.endswith(".npy")}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(self._names[key])
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)
            n_name, n_extra = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            offset = f.tell()
            if dtype.hasobject or math.prod(shape) <= 1:
                f.seek(offset)
                return np.fromfile(f, dtype=dtype, count=math.prod(shape)
                                   ).reshape(shape)
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order="F" if fortran else "C")


def _rebuild(like, flat, prefix=(), cut=None):
    """A tree of ``like``'s structure, leaves from ``flat`` (a dict, or
    the open npz, read an array at a time) in the dtypes and on the
    devices of ``like``'s leaves; ``cut(path, tensor)``, where given,
    takes each stored (whole) leaf to ``like``'s piece of it first."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),), cut)
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), flat, prefix + (n,),
                                     cut) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, prefix + (str(i),), cut)
                          for i, v in enumerate(like))
    if isinstance(like, PackedNVFP4):
        return dataclasses.replace(like, **{
            f: _rebuild(getattr(like, f), flat, prefix + (f,), cut)
            for f in ("codes", "scales", "tensor_scale")})
    arr = flat[_SEP.join(prefix)]
    if isinstance(like, torch.Tensor):
        with warnings.catch_warnings():     # a read-only memmap: only read
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
        if cut is not None:
            t = cut(prefix, t)
        return t.to(device=like.device, dtype=like.dtype, copy=True)
    return np.array(arr)


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

    def _npz(self, step: int) -> _Npz:
        return _Npz(os.path.join(self.dir, f"step_{step:010d}",
                                 "arrays.npz"))

    def _valid(self, step: int) -> bool:
        path = os.path.join(self.dir, f"step_{step:010d}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            with self._npz(step) as z:          # an array at a time
                return (_digest(z) == meta["digest"]
                        and sorted(z) == meta["keys"])
        except Exception:
            return False

    def latest_step(self) -> int | None:
        for s in reversed(self.all_steps()):
            if self._valid(s):
                return s
        return None

    def restore(self, step: int, like: Any, cut=None) -> Any:
        """Restore into the structure, dtypes and devices of ``like``,
        an array at a time.  ``cut(path, whole)``: on a training mesh,
        this rank's shard of each stored whole leaf (``like`` holds the
        shards; ``core.qad.shard_cutter``)."""
        with self._npz(step) as z:
            return _rebuild(like, z, cut=cut)

    def restore_latest(self, like: Any, cut=None) -> tuple[int, Any] | None:
        s = self.latest_step()
        if s is None:
            return None
        return s, self.restore(s, like, cut)

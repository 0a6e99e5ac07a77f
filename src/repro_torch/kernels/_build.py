"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked into
one shared library under ``<repo>/build/kernels/``.  The library has a
plain C interface and is loaded with ``ctypes``: no PyTorch header is
compiled, so a build takes seconds.  Its file name carries a hash of the
sources and flags, so an edited source is rebuilt.

No ``--use_fast_math``: the qdq kernel must be bitwise equal to its plain
version, which needs IEEE division and round-to-nearest-even, and the KL
and paged-attention kernels use the accurate ``expf`` and ``logf``.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrapper calls ``check`` on it.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream are void*, sizes are int
SIGNATURES = {
    # (x, x_is_f32, amax, mode, n_blocks, seg_blocks, chunk_blocks, ws,
    #  n_items, out, stream)
    "nvfp4_qdq": [_P, _I, _P, _I, _L, _L, _L, _P, _L, _P, _P],
    # (x, x_is_f32, codes, scales, tensor_scale, out, out_is_f32,
    #  m, n, k_logical, k_stored, stream)
    "nvfp4_matmul": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (x, x_is_f32, codes, scales, tensor_scale, ts_stride, out, out_is_f32,
    #  groups, m, n, k_logical, k_stored, stream)
    "nvfp4_matmul_grouped": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                             _I, _P],
    # (t, s, is_f32, kl, z_t, z_s, rows, v, stream)
    "kl_fwd": [_P, _P, _I, _P, _P, _P, _I, _I, _P],
    # (t, s, is_f32, z_t, z_s, g_tok, ds, rows, v, stream)
    "kl_bwd": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P],
    # (q, q strides b, s, h, k, v, k_scale, v_scale, fp8, block_tables,
    #  its row stride, pos, pos strides b, s, pos_is_i64, out, b, s, h, hkv,
    #  hd, bs, mb, window, n_split, chunk, q_vec, scale, stream)
    "paged_attention": [_P, _L, _L, _L, _P, _P, _P, _P, _I, _P, _L, _P, _L,
                        _L, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for these sources is missing.

    Returns the library's path and the compiler's log (``-Xptxas -v``
    prints registers, shared memory and spills of every kernel).
    """
    lib = BUILD_DIR / f"libnvfp4_kernels_{_digest()}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            objs.append(str(obj))
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                               *objs], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib, "\n".join(log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


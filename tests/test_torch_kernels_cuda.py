"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode.  The file imports no JAX, so the machine with the card
runs it as it is (that machine has no JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: ``nvfp4_qdq`` bitwise (the same f32 operations in the same
order); ``nvfp4_matmul`` within one bf16 ulp of the plain version's f32
product plus 2^-20 * (|x| @ |W|^T), a bound on summing the same exact
products in another f32 order.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.core import nvfp4
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain versions' f32 products must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _matmul_ok(x, p, out_dtype=torch.bfloat16):
    y = ops.nvfp4_matmul(x, p, out_dtype).float()
    y32 = ref.nvfp4_matmul_ref(x, p, torch.float32)
    w = nvfp4.unpack(p, torch.bfloat16).float()[:, : p.k]
    bound = 2.0 ** -20 * (x.float().abs() @ w.abs().T)
    if out_dtype == torch.bfloat16:
        bound += torch.exp2(torch.floor(torch.log2(y32.abs().clamp_min(1e-30))) - 7)
    return bool(((y - y32).abs() <= bound).all())


@pytest.mark.parametrize("shape", [(4, 3584), (256, 18944), (3, 5, 48), (1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scope", ["tensor", "row", "token"])
def test_qdq_kernel_bitwise(gen, shape, dtype, scope):
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    x.view(-1)[:16] = 0.0                     # an all-zero block
    amax = None
    if scope == "row":
        amax = x.float().abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    elif scope == "token":
        amax = x.float().abs().amax(dim=-1, keepdim=True)
    got = ops.nvfp4_qdq(x, amax)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(ref.nvfp4_qdq_ref(x, amax)))


@pytest.mark.parametrize("m,k,n", [(4, 3584, 4608), (4, 18944, 3584),
                                   (256, 3584, 3584), (1, 48, 40),
                                   (33, 80, 200), (9, 256, 96)])
def test_matmul_kernel_within_bound(gen, m, k, n):
    x = ops.nvfp4_qdq((torch.randn((m, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    assert _matmul_ok(x, ops.pack_weight(w.to(torch.bfloat16)))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_padded_k(gen, x_dtype, out_dtype):
    """orig_k (40) below the stored K (48): x carries the logical K."""
    x = torch.randn((5, 40), generator=gen, device="cuda").to(x_dtype)
    w = torch.nn.functional.pad(torch.randn((24, 40), generator=gen,
                                            device="cuda"), (0, 8))
    p = dataclasses.replace(nvfp4.pack(w), orig_k=40)
    assert _matmul_ok(x, p, out_dtype)


def test_launch_counters_count_card_launches(gen):
    ops.reset_launches()
    x = torch.randn((4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ops.nvfp4_matmul(ops.nvfp4_qdq(x), ops.pack_weight(
        torch.randn((64, 32), generator=gen, device="cuda")))
    torch.cuda.synchronize()
    assert ops.launches == {"nvfp4_qdq": 1, "nvfp4_matmul": 1}

"""NVFP4 numerics, packing and PTQ of the PyTorch port against the JAX
package, on the CPU.

The same numpy inputs go through both.  Parity level: **bitwise** for
qdq, scales, packed codes, unpacking and PTQ (the same elementwise f32
operations in the same order; the activation QDQ is held to the reference
as its jitted forward computes it, see ``test_q_act_bitwise``);
**tolerance** for the packed matmul's plain version, which sums in another
order (rtol 1e-4 / atol 1e-3 in f32, the reference's own kernel tolerance).
``test_torch_kernels_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import nvfp4 as jnvfp4
from repro.core import ptq as jptq
from repro.core import qconfig as jqconfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import nvfp4, ptq, qconfig
from repro_torch.kernels import ops
from repro_torch.models import get_model

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16),
          "f32": (jnp.float32, torch.float32, np.uint32, torch.int32)}


def _inputs(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bits_jax(a, ubits):
    return np.asarray(a).view(ubits)


def _bits_torch(t, ibits, ubits):
    return t.contiguous().view(ibits).numpy().view(ubits)


def _jax_packed_numpy(p):
    return {"codes": np.asarray(p.codes),
            "scales": np.asarray(p.scales.astype(jnp.float32)),
            "tensor_scale": np.asarray(p.tensor_scale, np.float32),
            "orig_k": p.orig_k}


def _assert_packed_equal(got: nvfp4.PackedNVFP4, want):
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.float().numpy(),
                                  np.asarray(want.scales.astype(jnp.float32)))
    np.testing.assert_array_equal(got.tensor_scale.numpy(),
                                  np.asarray(want.tensor_scale))
    assert got.orig_k == want.orig_k
    assert tuple(got.tensor_scale.shape) == tuple(want.tensor_scale.shape)


@pytest.mark.parametrize("shape", [(4, 3584), (7, 1, 64), (3, 5, 48)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("scope", ["tensor", "row", "token"])
def test_q_act_bitwise(shape, dtype, scope):
    """QuantConfig.q_act: the port's nvfp4_qdq op (plain on the CPU) gives
    the bits of the reference's q_act as its forward runs it, under
    ``jax.jit``: there XLA turns the divisions by 6 and by 448 * 6 into
    multiplications by their f32 reciprocals."""
    jdt, tdt, ubits, ibits = DTYPES[dtype]
    x = _inputs(shape, sum(shape))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jq = jqconfig.QuantConfig(act_scope=scope)
    want = jax.jit(lambda v: jq.q_act(v, "mlp"))(jx)
    got = qconfig.QuantConfig(act_scope=scope).q_act(tx, "mlp")
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits_torch(got, ibits, ubits),
                                  _bits_jax(want, ubits))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_qdq_and_scales_bitwise(dtype):
    jdt, tdt, ubits, ibits = DTYPES[dtype]
    x = _inputs((64, 18944), 1)
    x[3, :16] = 0.0                       # an all-zero block
    x[5, 7] = -0.0
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(_bits_torch(nvfp4.qdq(tx), ibits, ubits),
                                  _bits_jax(jnvfp4.qdq(jx), ubits))
    amax = np.float32(2.5)
    np.testing.assert_array_equal(
        _bits_torch(nvfp4.qdq(tx, torch.tensor(amax)), ibits, ubits),
        _bits_jax(jnvfp4.qdq(jx, jnp.asarray(amax)), ubits))
    js, ts = jnvfp4.compute_scales(jx), nvfp4.compute_scales(tx)
    np.testing.assert_array_equal(ts.block.numpy(), np.asarray(js.block))
    np.testing.assert_array_equal(ts.tensor.numpy(), np.asarray(js.tensor))


def test_qdq_reciprocal_form_matches_jitted_reference():
    """Where eager and jitted reference QDQ part (per-row amaxes of a wide
    activation), ``reciprocal=True`` follows the jitted bits and the default
    the eager bits."""
    x = _inputs((64, 18944), 4)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jamax = jnp.max(jnp.abs(jx), axis=-1, keepdims=True)
    tamax = torch.from_numpy(np.asarray(jamax))
    eager = np.asarray(jnvfp4.qdq(jx, jamax))
    jitted = np.asarray(jax.jit(jnvfp4.qdq)(jx, jamax))
    assert not np.array_equal(eager, jitted)
    np.testing.assert_array_equal(nvfp4.qdq(tx, tamax).numpy(), eager)
    np.testing.assert_array_equal(
        nvfp4.qdq(tx, tamax, reciprocal=True).numpy(), jitted)


@pytest.mark.parametrize("n_lead", [0, 1])
def test_pack_unpack_bitwise(n_lead):
    shape = (3, 40, 64) if n_lead else (40, 96)
    x = _inputs(shape, 2)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jp, tp = jnvfp4.pack(jx, n_lead=n_lead), nvfp4.pack(tx, n_lead=n_lead)
    _assert_packed_equal(tp, jp)
    # unpack from the bridged reference codes
    bp = params_from_numpy({"w": _jax_packed_numpy(jp)}, "cpu")["w"]
    np.testing.assert_array_equal(
        nvfp4.unpack(bp).view(torch.int16).numpy().view(np.uint16),
        np.asarray(jnvfp4.unpack(jp)).view(np.uint16))
    np.testing.assert_array_equal(
        nvfp4.unpack_layout(bp, 0, torch.float32).numpy(),
        np.asarray(jnvfp4.unpack_layout(jp, 0, jnp.float32)))


@pytest.mark.parametrize("n_lead", [0, 1])
def test_pack_along_odd_k_bitwise(n_lead):
    """An odd K (40) is padded to 48 by _moved_padded; orig_k remembers 40."""
    shape = (2, 40, 24) if n_lead else (40, 24)
    axis = n_lead
    x = _inputs(shape, 3)
    jw = jnp.asarray(x).astype(jnp.bfloat16)
    tw = torch.from_numpy(x).to(torch.bfloat16)
    jp = jptq._pack_along(jw, axis, n_lead)
    tp = ptq._pack_along(tw, axis, n_lead)
    _assert_packed_equal(tp, jp)
    assert tp.orig_k == 40 and tp.codes.shape[-1] == 24
    np.testing.assert_array_equal(
        ptq._qdq_along(tw, axis, n_lead).float().numpy(),
        np.asarray(jptq._qdq_along(jw, axis, n_lead).astype(jnp.float32)))
    np.testing.assert_array_equal(
        nvfp4.unpack_layout(tp, axis, torch.float32).numpy(),
        np.asarray(jnvfp4.unpack_layout(jp, axis, jnp.float32)))


@pytest.mark.parametrize("fmt", ["qdq", "packed"])
def test_quantize_weights_bitwise(fmt):
    """PTQ of the whole acereason-7b-smoke tree, slice by slice in the port
    and with n_lead scales in the reference: the same bits."""
    jcfg = jconfigs.get_smoke("acereason-7b")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    qc = dataclasses.replace(jqconfig.NVFP4_ALL, weight_format=fmt)
    want = jptq.quantize_weights(jparams, jmodel.param_specs(jcfg), qc)

    cfg = configs.get_smoke("acereason-7b")
    dense = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams), "cpu")
    got = ptq.quantize_weights(
        dense, get_model(cfg).param_specs(cfg),
        dataclasses.replace(qconfig.NVFP4_ALL, weight_format=fmt))
    for name in ("wqkv", "wo", "wg", "wu", "wd"):
        g, w = got["layers"][name], want["layers"][name]
        if fmt == "packed":
            _assert_packed_equal(g, w)
        else:
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                np.asarray(w).view(np.uint16))
    # lm_head and embed are not quantized by the "all" recipe
    assert got["lm_head"] is dense["lm_head"]


@pytest.mark.parametrize("m,k,n", [(1, 48, 40), (33, 80, 200)])
def test_matmul_plain_matches_reference(m, k, n):
    """The port's plain nvfp4_matmul against the reference oracle."""
    x = _inputs((m, k), m + k + n, 1.0)
    w = _inputs((k, n), m + k + n + 1, 1.0)
    jp = jops.pack_weight(jnp.asarray(w))
    want = jref.nvfp4_matmul_ref(jnp.asarray(x), jp, out_dtype=jnp.float32)
    tp = ops.pack_weight(torch.from_numpy(w))
    _assert_packed_equal(tp, jp)
    got = ops.nvfp4_matmul(torch.from_numpy(x), tp, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def test_matmul_plain_matches_pallas_interpret_padded_k():
    """Against the Pallas kernel in interpret mode, with orig_k < stored K."""
    x = _inputs((4, 40), 7, 1.0)
    w = _inputs((40, 24), 8, 1.0)
    jp = jptq._pack_along(jnp.asarray(w), 0)
    want = jops.nvfp4_matmul(jnp.asarray(x), jp, out_dtype=jnp.float32,
                             interpret=True)
    tp = params_from_numpy({"w": _jax_packed_numpy(jp)}, "cpu")["w"]
    got = ops.nvfp4_matmul(torch.from_numpy(x), tp, out_dtype=torch.float32)
    assert tuple(got.shape) == (4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)
    # bf16 in and out, as serving calls it
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_allclose(
        ops.nvfp4_matmul(xb, tp).float().numpy(),
        np.asarray(jref.nvfp4_matmul_ref(jnp.asarray(x).astype(jnp.bfloat16),
                                         jp).astype(jnp.float32)),
        rtol=1e-2, atol=1e-2)


def test_fake_quant_straight_through():
    x = torch.from_numpy(_inputs((8, 32), 9)).requires_grad_()
    y = nvfp4.fake_quant(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jnvfp4.qdq(jnp.asarray(x.detach().numpy()))))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones((8, 32), np.float32))
    amax = torch.tensor(2.0, requires_grad=True)
    x.grad = None
    nvfp4.fake_quant_calibrated(x, amax).sum().backward()
    assert float(amax.grad) == 0.0
    np.testing.assert_array_equal(x.grad.numpy(), np.ones((8, 32), np.float32))

"""The port's quantization primitives and Hessian machinery against JAX.

Codes, packing and unpacking are pinned bitwise; the Hessian damping, the
GPTQ factor and the RPIQ block curvature ≤ 1e-5 of the largest entry (the
two frameworks' LAPACK calls round differently); GPTQ from a Hessian end
to end at the kernel tests' cell pin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gptq as jgptq
from repro.core import hessian as jhess
from repro.core import quant as jquant
from repro.core import rpiq as jrpiq
from repro_torch.core import gptq as tgptq
from repro_torch.core import hessian as thess
from repro_torch.core import quant as tquant
from repro_torch.core import rpiq as trpiq

from test_torch_kernels import assert_cells_close, assert_rel, t


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_codes_and_packing_bitwise(symmetric):
    rng = np.random.RandomState(0)
    w = (rng.randn(24, 64) * 0.1).astype(np.float32)
    g = 16
    qj = jquant.compute_qparams(jnp.asarray(w), 4, g, symmetric)
    qt = tquant.compute_qparams(t(w), 4, g, symmetric)
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qj.scales))
    np.testing.assert_array_equal(qt.zeros.numpy(), np.asarray(qj.zeros))
    cj = jquant.quantize_codes(jnp.asarray(w), qj, 4, g, symmetric)
    ct = tquant.quantize_codes(t(w), qt, 4, g, symmetric)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        tquant.dequantize_codes(ct, qt, g, symmetric).numpy(),
        np.asarray(jquant.dequantize_codes(cj, qj, g, symmetric)))
    pj = jquant.pack_quantized(jnp.asarray(w), 4, g, symmetric)
    pt = tquant.pack_quantized(t(w), 4, g, symmetric)
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(pj.packed))
    np.testing.assert_array_equal(pt.zeros.numpy(), np.asarray(pj.zeros))
    assert pt.shape == tuple(pj.shape) and pt.group_size == pj.group_size
    np.testing.assert_array_equal(
        tquant.dequantize_packed(pt).numpy(),
        np.asarray(jquant.dequantize_packed(pj)))


def test_pack_unpack_int4_bitwise():
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 16, size=(7, 32)).astype(np.int32)
    pj = jquant.pack_int4(jnp.asarray(codes))
    pt = tquant.pack_int4(t(codes))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tquant.unpack_int4(pt).numpy(), codes)
    np.testing.assert_array_equal(tquant.unpack_int4(pt).numpy(),
                                  np.asarray(jquant.unpack_int4(pj)))


@pytest.mark.parametrize("stacked", [False, True])
def test_damped_and_cholesky_inverse_upper(stacked):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 200, 64).astype(np.float32)
    x[:, :, 5] = 0.0                       # a dead column: diag forced to 1
    H = np.einsum("bni,bnj->bij", x, x)
    if not stacked:
        H = H[0]
    count = np.full(H.shape[:-2], 200, np.int32)
    hj = jhess.damped(jhess.HessianState(jnp.asarray(H),
                                         jnp.asarray(count)), 0.01)
    ht = thess.damped(thess.HessianState(t(H), t(count)), 0.01)
    _close(ht.numpy(), hj)
    _close(thess.cholesky_inverse_upper(ht).numpy(),
           jhess.cholesky_inverse_upper(hj))


def test_accumulate_matches_jax():
    rng = np.random.RandomState(3)
    xs = [rng.randn(2, 10, 48).astype(np.float32) for _ in range(3)]
    sj = jhess.init_hessian(48)
    st = thess.init_hessian(48)
    for x in xs:
        sj = jhess.accumulate(sj, jnp.asarray(x))
        st = thess.accumulate(st, t(x))
    assert int(st.count) == int(sj.count) == 60
    _close(st.H.numpy(), sj.H)


@pytest.mark.parametrize("exact_gram", [False, True])
def test_block_curvature_inv_matches_jax(exact_gram):
    rng = np.random.RandomState(4)
    b, n, in_dim, bs = 2, 256, 256, 128
    x = rng.randn(b, 512, in_dim).astype(np.float32)
    H = np.einsum("bni,bnj->bij", x, x)
    hd = np.asarray(jhess.damped(jhess.HessianState(
        jnp.asarray(H), jnp.full((b,), 512, jnp.int32)), 0.01))
    x_last = x[:, -n:]
    hc = np.full((b,), 512, np.int32)
    xc = np.full((b,), n, np.int32)
    got = trpiq._block_curvature_inv(t(x_last), t(hd), t(hc), t(xc),
                                     block_size=bs, exact_gram=exact_gram)
    want = jax.vmap(lambda xl, h, a, c: jrpiq._block_curvature_inv(
        xl, h, a, c, block_size=bs, exact_gram=exact_gram))(
        jnp.asarray(x_last), jnp.asarray(hd), jnp.asarray(hc),
        jnp.asarray(xc))
    _close(got.numpy(), want)


def test_gptq_from_hessian_end_to_end():
    rng = np.random.RandomState(5)
    w = (rng.randn(40, 128) * 0.1).astype(np.float32)
    x = rng.randn(300, 128).astype(np.float32)
    sj = jhess.accumulate(jhess.init_hessian(128), jnp.asarray(x))
    st = thess.accumulate(thess.init_hessian(128), t(x))
    kw = dict(bits=4, group_size=32, blocksize=64, percdamp=0.01)
    rj = jgptq.gptq_from_hessian(jnp.asarray(w), sj, **kw)
    rt = tgptq.gptq_from_hessian(t(w), st, **kw)
    assert_cells_close(rt.w_q.numpy(), rj.w_q)
    assert_cells_close(rt.scales.numpy(), rj.scales)
    assert_cells_close(rt.zeros.numpy(), rj.zeros)
    assert_rel(rt.err.numpy(), rj.err, 1e-5)


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_rtn_quantize_matches_jax(symmetric):
    rng = np.random.RandomState(6)
    w = (rng.randn(3, 16, 64) * 0.1).astype(np.float32)
    rj = jgptq.rtn_quantize_batched(jnp.asarray(w), group_size=32,
                                    symmetric=symmetric)
    rt = tgptq.rtn_quantize_batched(t(w), group_size=32, symmetric=symmetric)
    for a, b in zip(rt[:3], rj[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rpiq_refine_single_linear_matches_jax():
    rng = np.random.RandomState(7)
    w = (rng.randn(32, 128) * 0.1).astype(np.float32)
    x = rng.randn(256, 128).astype(np.float32)
    sj = jhess.accumulate(jhess.init_hessian(128), jnp.asarray(x))
    hd = jhess.damped(sj, 0.01)
    r1 = jgptq.gptq_quantize(jnp.asarray(w),
                             jhess.cholesky_inverse_upper(hd),
                             group_size=32, blocksize=64)
    kw = dict(bits=4, group_size=32, block_size=64, alpha=0.1, t_max=3)
    args = (r1.w_q, jnp.asarray(w), jnp.asarray(x[-128:]), hd, r1.scales,
            r1.zeros)
    rj = jrpiq.rpiq_refine(*args, h_count=sj.count, impl="xla", **kw)
    rt = trpiq.rpiq_refine(*(t(a) for a in args), h_count=t(sj.count),
                           **kw)
    assert_cells_close(rt.w_q.numpy(), rj.w_q)
    assert_rel(rt.loss_history.numpy(), rj.loss_history, 1e-5)
    assert int(rt.iters_run) == int(rj.iters_run)

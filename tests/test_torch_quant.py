"""The port's quantization primitives and Hessian machinery against JAX.

Codes, packing and unpacking are pinned bitwise; the Hessian damping, the
GPTQ factor and the RPIQ block curvature ≤ 1e-5 of the largest entry (the
two frameworks' LAPACK calls round differently); GPTQ from a Hessian end
to end at the kernel tests' cell pin.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
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


# ---------------------------------------------------------------------------
# the helpers only the reference's tests call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixed", [False, True], ids=["own", "fixed_qp"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_fake_quantize_bitwise(symmetric, fixed):
    rng = np.random.RandomState(3)
    w = (rng.randn(16, 64) * 0.1).astype(np.float32)
    # halves on the grid: round half to even in both packages
    w[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -2.5, 0.0]) * 0.01
    qj = qt = None
    if fixed:
        other = (rng.randn(16, 64) * 0.1).astype(np.float32)
        qj = jquant.compute_qparams(jnp.asarray(other), 4, 16, symmetric)
        qt = tquant.QuantParams(t(np.asarray(qj.scales)),
                                t(np.asarray(qj.zeros)))
    want = jquant.fake_quantize(jnp.asarray(w), 4, 16, symmetric, qj)
    got = tquant.fake_quantize(t(w), 4, 16, symmetric, qt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_quantize_column_bitwise(symmetric):
    rng = np.random.RandomState(4)
    w = (rng.randn(32) * 0.1).astype(np.float32)
    qp = jquant.compute_qparams(jnp.asarray(w[:, None].repeat(8, 1)), 4, 8,
                                symmetric)
    scale, zero = np.asarray(qp.scales[:, 0]), np.asarray(qp.zeros[:, 0])
    want = jquant.quantize_column(jnp.asarray(w), jnp.asarray(scale),
                                  jnp.asarray(zero), 4, symmetric)
    got = tquant.quantize_column(t(w), t(scale), t(zero), 4, symmetric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_quant_error_matches_jax(symmetric):
    w = (np.random.RandomState(5).randn(24, 128) * 0.1).astype(np.float32)
    want = float(jquant.quant_error(jnp.asarray(w), 4, 32, symmetric))
    got = float(tquant.quant_error(t(w), 4, 32, symmetric))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_stack_states_bitwise():
    rng = np.random.RandomState(6)
    hs = [rng.randn(8, 8).astype(np.float32) for _ in range(3)]
    counts = [5, 0, 17]
    want = jhess.stack_states([jhess.HessianState(jnp.asarray(h), c)
                               for h, c in zip(hs, counts)])
    got = thess.stack_states([thess.HessianState(t(h), c)
                              for h, c in zip(hs, counts)])
    np.testing.assert_array_equal(got.H.numpy(), np.asarray(want.H))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.dtype == torch.int32


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("rhs_cols", [0, 5], ids=["vector", "matrix"])
def test_block_solver_matches_jax(rhs_cols):
    rng = np.random.RandomState(7)
    x = rng.randn(96, 48).astype(np.float32)
    hd = np.asarray(jhess.damped(jhess.HessianState(
        jnp.asarray(x.T @ x), 96), 0.01))
    rhs = rng.randn(16, rhs_cols).astype(np.float32) if rhs_cols else \
        rng.randn(16).astype(np.float32)
    want = jhess.block_solver(jnp.asarray(hd), 16, 32)(jnp.asarray(rhs))
    got = thess.block_solver(t(hd), 16, 32)(t(rhs))
    assert got.shape == tuple(want.shape)
    assert _rel_err(got.numpy(), want) <= 1e-6


def test_gram_solver_matches_jax():
    rng = np.random.RandomState(8)
    xb = rng.randn(64, 24).astype(np.float32)
    rhs = rng.randn(24, 3).astype(np.float32)
    want = jhess.gram_solver(jnp.asarray(xb))(jnp.asarray(rhs))
    got = thess.gram_solver(t(xb))(t(rhs))
    assert _rel_err(got.numpy(), want) <= 1e-6


def test_gram_solver_singular_as_accurate_as_jax():
    """One batch of fewer rows than columns: the Gram is singular and the
    relative damping alone makes it solvable (condition ~570 at 1e-2). Both
    fp32 solves sit ~1.3e-5 from the fp64 solution, so the port is held
    against that solution: no further off it than the reference's 1.5x."""
    rng = np.random.RandomState(8)
    xb = rng.randn(8, 24).astype(np.float32)
    rhs = rng.randn(24, 3).astype(np.float32)
    g = xb.astype(np.float64).T @ xb.astype(np.float64)
    lam = 1e-2 * np.mean(np.diag(g)) + 1e-12
    exact = np.linalg.solve(g + lam * np.eye(24), rhs)
    want = jhess.gram_solver(jnp.asarray(xb), 1e-2)(jnp.asarray(rhs))
    got = thess.gram_solver(t(xb), 1e-2)(t(rhs))
    assert _rel_err(got.numpy(), exact) <= max(
        1.5 * _rel_err(want, exact), 1e-6)

"""The selective scan's backward (Mamba training) against the JAX package.

- ``ref.selective_scan_backward`` against ``jax.vjp`` of
  ``repro.kernels.ref.selective_scan_ref`` on the same numpy inputs from a
  seed, with nonzero h0 and cotangents of y and h_last: n 8 and 16, S 1,
  33 and 64, u in fp32 and bf16; every fp32 gradient within 1e-5 of its
  largest magnitude, du in bf16 within one bf16 ulp of JAX's (the ulp at
  no less than 1e-3 of the largest, as tests/test_torch_kernels.py's);
- ``ops.selective_scan`` with grad on goes through the autograd Function
  (its backward the plain version on the CPU): gradients within 1e-6 of
  autograd through ``ref.selective_scan``, with B and C views of one
  projection and h_last unused (its cotangent None) or used;
- falcon-mamba smoke's ``loss_fn`` gradients through the Function against
  JAX's at tests/test_torch_training.py's 1e-5 per-leaf pin, the plain
  backward called once a layer.

On the card (``gpu``, skipped without one): ``selective_scan_bwd_cuda``
against the plain backward at the same pins, two launches bitwise equal,
and a view-fed Function call launching each kernel once. JAX is imported
inside the tests that compare with it.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

GRADS = ("du", "ddt", "dB", "dC", "dA_log", "dD", "dh0")


def scan_inputs(rng, b, s, d, n):
    """Numpy inputs of the scan and its cotangents: dt > 0 as softplus
    gives it, a_log of Mamba's init, h0 and the cotangents nonzero."""
    u = rng.randn(b, s, d).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, d) - 1.0)).astype(np.float32)
    bm = rng.randn(b, s, n).astype(np.float32)
    cm = rng.randn(b, s, n).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1)))
    d_skip = rng.randn(d).astype(np.float32)
    h0 = (0.1 * rng.randn(b, d, n)).astype(np.float32)
    dy = rng.randn(b, s, d).astype(np.float32)
    dh_last = rng.randn(b, d, n).astype(np.float32)
    return u, dt, bm, cm, a_log, d_skip, h0, dy, dh_last


def to_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16 (returned as fp32)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def bf16_ulp(want):
    a = np.maximum(np.abs(want), 1e-3 * np.max(np.abs(want)))
    return np.exp2(np.floor(np.log2(a)) - 7)


def torch_grads(inputs, udt):
    u, *rest, dy, dh_last = [torch.from_numpy(a) for a in inputs]
    out = ref.selective_scan_backward(u.to(udt), *rest, dy.to(udt), dh_last)
    return [g.float().numpy() for g in out]


def jax_grads(inputs, udt):
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import selective_scan_ref
    u, dt, bm, cm, a_log, d_skip, h0, dy, dh_last = inputs
    jdt = jnp.bfloat16 if udt == torch.bfloat16 else jnp.float32
    prim = (jnp.asarray(u, jdt),) + tuple(
        jnp.asarray(a) for a in (dt, bm, cm, a_log, d_skip, h0))
    _, vjp = jax.vjp(selective_scan_ref, *prim)
    out = vjp((jnp.asarray(dy, jdt), jnp.asarray(dh_last)))
    return [np.asarray(g.astype(jnp.float32)) for g in out]


def assert_grads(got, want, udt, pin=1e-5):
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, name
        diff = np.abs(g - w)
        if name == "du" and udt == torch.bfloat16:
            assert np.all(diff <= bf16_ulp(w)), (name, float(diff.max()))
        else:
            assert diff.max() <= pin * np.abs(w).max(), \
                (name, float(diff.max() / np.abs(w).max()))


@pytest.mark.parametrize("udt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 33, 64])
@pytest.mark.parametrize("n", [8, 16])
def test_plain_backward_matches_jax_vjp(n, s, udt):
    inputs = scan_inputs(np.random.RandomState(100 * n + s), 2, s, 32, n)
    if udt == torch.bfloat16:          # u and dy as bf16 values
        inputs = (to_bf16(inputs[0]),) + inputs[1:7] + (
            to_bf16(inputs[7]), inputs[8])
    assert_grads(torch_grads(inputs, udt), jax_grads(inputs, udt), udt)


def _function_case(seed, udt, use_h_last):
    """Gradients of one loss through ``fn`` (``ops.selective_scan`` or
    ``ref.selective_scan``) with B and C views of a projection (B, S, r +
    2n) and dt a view of another, as ``recurrent.mamba_block`` feeds it."""
    rng = np.random.RandomState(seed)
    b, s, d, n, r = 2, 20, 16, 8, 4
    u = torch.from_numpy(rng.randn(b, s, d).astype(np.float32)).to(udt)
    proj = torch.from_numpy(rng.randn(b, s, r + 2 * n).astype(np.float32))
    dt_all = torch.from_numpy(rng.randn(b, s, 2 * d).astype(np.float32))
    a_log = torch.log(torch.arange(1, n + 1.0)).repeat(d, 1)
    d_skip = torch.from_numpy(rng.randn(d).astype(np.float32))
    h0 = torch.from_numpy(0.1 * rng.randn(b, d, n).astype(np.float32))
    w_y = torch.from_numpy(rng.randn(b, s, d).astype(np.float32))
    w_h = torch.from_numpy(rng.randn(b, d, n).astype(np.float32))
    leaves = [u, proj, dt_all, a_log, d_skip, h0]

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        uu, pr, dta, al, ds, hh = xs
        dt = torch.nn.functional.softplus(dta[..., ::2])      # a view
        y, h_last = fn(uu, dt, pr[..., r:r + n], pr[..., r + n:], al, ds,
                       hh)
        loss = (y.float() * w_y).sum()
        if use_h_last:
            loss = loss + (h_last * w_h).sum()
        return torch.autograd.grad(loss, xs)
    return grads


@pytest.mark.parametrize("use_h_last", [False, True],
                         ids=["h_last-unused", "h_last-used"])
@pytest.mark.parametrize("udt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_function_matches_autograd_through_the_plain_scan(udt, use_h_last):
    grads = _function_case(7, udt, use_h_last)
    ops.reset_kernel_launches()
    got = grads(ops.selective_scan)
    want = grads(ref.selective_scan)
    assert ops.kernel_launches() == dict.fromkeys(ops.kernel_launches(), 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= \
            1e-6 * float(w.float().abs().max())


def test_no_grad_call_is_the_forward_alone():
    """Under no_grad the dispatcher is the forward alone, also on inputs
    that require grad: bitwise the plain version, no grad_fn."""
    rng = np.random.RandomState(8)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, 2, 9, 16, 8)[:7]]
    args[4].requires_grad_(True)
    with torch.no_grad():
        got = ops.selective_scan(*args)
        want = ref.selective_scan(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.grad_fn is None


def test_falcon_mamba_loss_grads_through_the_function_match_jax(
        monkeypatch):
    from test_torch_training import check_loss_and_grads
    calls = []
    plain = ref.selective_scan_backward

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)
    monkeypatch.setattr(ref, "selective_scan_backward", counted)
    check_loss_and_grads("falcon-mamba-7b")
    assert len(calls) == 3                     # the smoke config's layers


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("udt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 33, 64])
@pytest.mark.parametrize("n", [8, 16])
def test_gpu_kernel_matches_plain_backward_and_repeats(cuda, n, s, udt):
    inputs = scan_inputs(np.random.RandomState(100 * n + s), 2, s, 128, n)
    u, *rest, dy, dh_last = [torch.from_numpy(a).to(cuda) for a in inputs]
    args = (u.to(udt), *rest, dy.to(udt), dh_last)
    ops.reset_kernel_launches()
    got = ops.selective_scan_bwd_cuda(*args)
    again = ops.selective_scan_bwd_cuda(*args)
    assert ops.kernel_launches()["selective_scan_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.selective_scan_backward(*args)
    assert_grads([g.float().cpu().numpy() for g in got],
                 [w.float().cpu().numpy() for w in want], udt)


@pytest.mark.gpu
def test_gpu_function_launches_both_kernels(cuda):
    rng = np.random.RandomState(3)
    u, dt, bm, cm, a_log, d_skip, h0 = [
        torch.from_numpy(a).to(cuda) for a in scan_inputs(rng, 2, 24, 64,
                                                          16)[:7]]
    a_log.requires_grad_(True)
    ops.reset_kernel_launches()
    y, _ = ops.selective_scan(u.requires_grad_(True), dt, bm, cm, a_log,
                              d_skip, h0)
    y.sum().backward()
    launches = ops.kernel_launches()
    assert launches["selective_scan"] == launches["selective_scan_bwd"] == 1
    assert torch.isfinite(a_log.grad).all() and torch.isfinite(u.grad).all()

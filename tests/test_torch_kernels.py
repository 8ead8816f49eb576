"""The port's kernels: plain PyTorch versions against the JAX package.

Each plain version (``repro_torch.kernels.ref`` through the CPU dispatcher
``repro_torch.kernels.ops``) is held against the JAX package's NumPy/jnp
oracles (``repro.kernels.ref``) and its dispatcher with ``impl="pallas"``
(interpret mode, as the JAX tests run it) and ``impl="xla"``, on the same
numpy inputs made from a seed.

Tolerances: hessian ≤ 1e-5·max|H|; w4a16 fp32 ≤ 1e-5 relative, bf16 ≤ 1
bf16 ulp (taken at no less than 1e-3 of the largest output, see
``bf16_ulp``); gptq/rpiq weights, scales and zeros ≤ 1e-6 absolute — except
that a grid cell may flip where a value sits within float rounding of a
rounding boundary (the two frameworks sum matrix products in different
orders), so at most 1e-3 of the cells may differ by more; Γ history and
projected loss ≤ 1e-5 relative; ``iters_run`` equal.

The CPU parity of ``int8_kv_attention`` and ``quant_pack`` is in
``tests/test_torch_kv.py``.

The CPU parity of ``selective_scan`` is in ``tests/test_torch_ssm.py``.

The ``gpu``-marked tests hold each CUDA kernel, the seven of them, against
its plain version on the card (``python -m pytest -m gpu
tests/test_torch_kernels.py``); without a card they skip. Pins there:
``int8_kv_attention`` ≤ 1e-5 of the largest output in fp32 and one bf16
ulp (as ``bf16_ulp``) in bf16; ``quant_pack`` bitwise; ``selective_scan``
y and h_last ≤ 1e-5 of their largest value in fp32, y within one bf16 ulp
in bf16, and a shape the kernel does not take raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hessian as jhess
from repro.core import rpiq as jrpiq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import rpiq as trpiq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CELL_ATOL = 1e-6
MAX_FLIP_FRAC = 1e-3


def assert_cells_close(got, want, atol=CELL_ATOL, max_frac=MAX_FLIP_FRAC):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    frac = float(np.mean(np.abs(got - want) > atol))
    assert frac <= max_frac, f"{frac:.2e} of cells differ by > {atol}"


def assert_rel(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


def bf16_ulp(want):
    """One bf16 ulp of each output, taken at no less than 1e-3 of the
    largest: below that, cancellation leaves outputs whose fp32 sums' own
    rounding (~1e-6 of the largest) exceeds their bf16 ulp."""
    a = np.maximum(np.abs(want), 1e-3 * np.max(np.abs(want)))
    return np.exp2(np.floor(np.log2(a)) - 7)


def t(a):
    return torch.from_numpy(np.array(a))


def _hessian_case(rng, b, n, d):
    """Stacked damped Hessians and their GPTQ factors, from JAX."""
    x = rng.randn(b, n, d).astype(np.float32)
    H = np.einsum("bni,bnj->bij", x, x)
    st = jhess.HessianState(jnp.asarray(H),
                            jnp.full((b,), n, jnp.int32))
    hd = jhess.damped(st, 0.01)
    u = jhess.cholesky_inverse_upper(hd)
    return x, np.asarray(hd), np.asarray(u)


# ---------------------------------------------------------------------------
# hessian_accum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(256, 128), (100, 72)])
def test_hessian_accum_matches_jax(n, d):
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    H0 = rng.randn(d, d).astype(np.float32)
    got = tops.hessian_accum(t(x), t(H0)).numpy()
    for want in (np.asarray(jref.hessian_accum_ref(jnp.asarray(x))),
                 np.asarray(jops.hessian_accum(jnp.asarray(x),
                                               impl="pallas")),
                 np.asarray(jops.hessian_accum(jnp.asarray(x), impl="xla"))):
        want = want + H0
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# w4a16_matmul
# ---------------------------------------------------------------------------

def _w4a16_case(rng, n=192, k=256, g=64):
    packed = rng.randint(0, 256, size=(n, k // 2)).astype(np.uint8)
    scales = (rng.rand(n, k // g) * 0.05 + 0.01).astype(np.float32)
    zeros = rng.randint(0, 16, size=(n, k // g)).astype(np.float32)
    return packed, scales, zeros, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(3, 1), (2, 8)], ids=["decode", "prefill"])
def test_w4a16_matches_jax(dtype, lead):
    rng = np.random.RandomState(1)
    packed, scales, zeros, g = _w4a16_case(rng)
    x = rng.randn(*lead, packed.shape[1] * 2).astype(np.float32)
    xt = t(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    got = tops.w4a16_matmul(xt, t(packed), t(scales), t(zeros),
                            group_size=g)
    assert got.dtype == xt.dtype and got.shape == (*lead, 192)
    got = got.float().numpy()
    args = (jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(zeros))
    wants = [jref.w4a16_matmul_ref(xj.reshape(-1, x.shape[-1]), *args,
                                   g).reshape(*lead, -1)]
    wants += [jops.w4a16_matmul(xj, *args, group_size=g, impl=impl)
              for impl in ("pallas", "xla")]
    for want in wants:
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
        else:
            assert np.all(np.abs(got - want) <= bf16_ulp(want))


# ---------------------------------------------------------------------------
# gptq_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_gptq_block_matches_jax(g, symmetric):
    rng = np.random.RandomState(2)
    b, out_dim, in_dim, bs = 3, 48, 256, 128
    _, _, u = _hessian_case(rng, b, 300, in_dim)
    w = (rng.randn(b, out_dim, in_dim) * in_dim ** -0.5).astype(np.float32)
    kw = dict(bits=4, group_size=g, blocksize=bs, symmetric=symmetric)
    got = [o.numpy() for o in tops.gptq_block(t(w), t(u), **kw)]
    wants = [jref.gptq_block_ref(w, u, **kw)]
    impls = ("pallas", "xla") if g == 128 else ("xla",)
    wants += [jops.gptq_block(jnp.asarray(w), jnp.asarray(u), impl=impl,
                              **kw) for impl in impls]
    for want in wants:
        w_q, scales, zeros, err = (np.asarray(a) for a in want)
        assert_cells_close(got[0], w_q)
        assert_cells_close(got[1], scales)
        assert_cells_close(got[2], zeros)
        assert_rel(got[3], err, 1e-5)


# ---------------------------------------------------------------------------
# rpiq_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact_gram,alpha,early_stop", [
    (False, 0.1, True), (True, 1.0, True), (False, 0.1, False),
    (True, 0.1, False)])
def test_rpiq_block_matches_jax(exact_gram, alpha, early_stop):
    """The JAX kernel tests' problem: a 512-row Hessian, the last 256 rows
    as the instance (a well-conditioned exact-gram curvature). Without the
    early stop the rounds run past the point where Γ turns up; there a
    large α amplifies rounding differences, so that case runs at α = 0.1."""
    rng = np.random.RandomState(3)
    b, out_dim, in_dim, n, g, bs, t_max = 3, 48, 256, 256, 64, 128, 4
    x_all, hd, u = _hessian_case(rng, b, 512, in_dim)
    x_last = x_all[:, -n:]
    w_fp = (rng.randn(b, out_dim, in_dim) * 0.1).astype(np.float32)
    w0, scales, zeros, _ = (np.asarray(a) for a in jref.gptq_block_ref(
        w_fp, u, bits=4, group_size=g, blocksize=bs))
    h_count = np.full((b,), 512, np.int32)
    x_count = np.full((b,), n, np.int32)
    kw = dict(bits=4, group_size=g, block_size=bs, alpha=alpha, t_max=t_max,
              early_stop=early_stop, exact_gram=exact_gram)
    got = trpiq.rpiq_refine_batched(
        t(w0), t(w_fp), t(x_last), t(hd), t(scales), t(zeros),
        h_count=t(h_count), x_count=t(x_count), **kw)
    got = [a.numpy() for a in got]
    jargs = [jnp.asarray(a) for a in (w0, w_fp, x_last, hd, scales, zeros)]
    jkw = dict(h_count=jnp.asarray(h_count), x_count=jnp.asarray(x_count),
               **kw)
    pallas = jrpiq.rpiq_refine_batched(*jargs, impl="pallas", **jkw)
    xla = jrpiq.rpiq_refine_batched(*jargs, impl="xla", **jkw)
    hinv = jax.vmap(lambda xl, h, hc, xc: jrpiq._block_curvature_inv(
        xl, h, hc, xc, block_size=bs, exact_gram=exact_gram))(
        *jargs[2:4], jkw["h_count"], jkw["x_count"])
    oracle = jref.rpiq_block_ref(w0, w_fp, x_last, np.asarray(hinv), scales,
                                 zeros, bits=4, group_size=g, block_size=bs,
                                 alpha=alpha, t_max=t_max,
                                 early_stop=early_stop)
    for want in (pallas, xla, oracle):
        w_q, w_cont, hist, ploss, iters = (np.asarray(a) for a in want)
        assert_cells_close(got[0], w_q)
        assert_rel(got[2], hist, 1e-5)
        assert_rel(got[3], ploss, 1e-5)
        np.testing.assert_array_equal(got[4], iters)
    # w_cont is the t_max-round iterate on both fused paths; the XLA body
    # stops at the early-stop round
    assert_cells_close(got[1], np.asarray(pallas.w_cont))
    if not early_stop:
        assert_cells_close(got[1], np.asarray(xla.w_cont))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    tops.reset_kernel_launches()
    rng = np.random.RandomState(5)
    x = t(rng.randn(16, 32).astype(np.float32))
    H = torch.zeros(32, 32)
    torch.testing.assert_close(tops.hessian_accum(x, H),
                               tref.hessian_accum(x, H), rtol=0, atol=0)
    packed, scales, zeros, g = _w4a16_case(rng, n=8, k=64, g=32)
    args = (t(packed), t(scales), t(zeros))
    torch.testing.assert_close(
        tops.w4a16_matmul(x[:, :].repeat(1, 2), *args, group_size=g),
        tref.w4a16_matmul(x.repeat(1, 2), *args, g), rtol=0, atol=0)
    kv = [t(a) for a in kv_case(rng, b=2, s=20, kv=2, r=2, hd=32,
                                kv_block=32)]
    torch.testing.assert_close(tops.int8_kv_attention(*kv, kv_block=32),
                               tref.int8_kv_attention(*kv, 32), rtol=0,
                               atol=0)
    w = x.repeat(1, 2)[:8]
    s, z = t(scales), t(zeros)
    torch.testing.assert_close(tops.quant_pack(w, s, z, group_size=32),
                               tref.quant_pack(w, s, z, 32), rtol=0, atol=0)
    scan = [t(a) for a in scan_case(rng, b=2, s=7, d=16, n=4)]
    for a, b in zip(tops.selective_scan(*scan), tref.selective_scan(*scan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tops.kernel_launches() == {k: 0 for k in tops.kernel_launches()}
    assert len(tops.kernel_launches()) == 7


def scan_case(rng, b, s, d, n, h0_scale=0.1):
    """selective-scan inputs as numpy fp32 (u, dt, B, C, a_log, d_skip,
    h0): dt > 0 as softplus gives it, a_log as the model initializes it."""
    return (rng.randn(b, s, d).astype(np.float32),
            np.log1p(np.exp(rng.randn(b, s, d) - 1)).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            np.log(np.tile(np.arange(1, n + 1, dtype=np.float32)[None],
                           (d, 1))),
            rng.randn(d).astype(np.float32),
            (rng.randn(b, d, n) * h0_scale).astype(np.float32))


def kv_case(rng, b, s, kv, r, hd, kv_block):
    """int8 KV-attention inputs as numpy arrays (q, k codes, k scales,
    v codes, v scales, kpos): kpos with -1 holes, a first lane written
    only to half its length and a last lane with no valid slot."""
    nb = hd // kv_block
    q = (rng.randn(b, kv, r, hd) * hd ** -0.5).astype(np.float32)
    kc = rng.randint(-127, 128, size=(b, s, kv, hd)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(b, s, kv, hd)).astype(np.int8)
    ks = (rng.rand(b, s, kv, nb) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(b, s, kv, nb) * 0.02 + 1e-3).astype(np.float32)
    kpos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kpos[rng.rand(b, s) < 0.2] = -1
    kpos[0, s // 2:] = -1
    kpos[-1] = -1
    return q, kc, ks, vc, vs, kpos


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_hessian_accum(cuda):
    x = torch.randn(512, 768, device=cuda)
    H = torch.randn(768, 768, device=cuda)
    want = tref.hessian_accum(x, H)
    got = tops.hessian_accum_cuda(x, H.clone())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_w4a16(cuda, m, dtype):
    rng = np.random.RandomState(6)
    packed, scales, zeros, g = _w4a16_case(rng, n=768, k=3072, g=128)
    args = [t(a).to(cuda) for a in (packed, scales, zeros)]
    x = torch.randn(m, 3072, device=cuda).to(dtype)
    want = tref.w4a16_matmul(x, *args, g).float()
    got = tops.w4a16_matmul_cuda(x, *args, g).float()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 2048])
def test_gpu_gptq_and_rpiq(cuda, n):
    """At n = 2048 rpiq_block's working set exceeds shared memory and the
    kernel keeps it in global scratch."""
    from repro_torch.kernels import build
    rng = np.random.RandomState(7)
    b, out_dim, in_dim, g, bs = 2, 96, 256, 64, 128
    scratch = build.load("rpiq_block").rpiq_block_scratch_floats(n, bs)
    assert (scratch > 0) == (n == 2048)
    x_all, hd, u = _hessian_case(rng, b, max(n, 512), in_dim)
    w = (rng.randn(b, out_dim, in_dim) * in_dim ** -0.5).astype(np.float32)
    kw = dict(bits=4, group_size=g, blocksize=bs, symmetric=False)
    wt, ut = t(w).to(cuda), t(u).to(cuda)
    want = tref.gptq_block(wt, ut, **kw)
    got = tops.gptq_block_cuda(wt, ut, **kw)
    for a, b_ in zip(got[:3], want[:3]):
        assert_cells_close(a.cpu(), b_.cpu())
    x = t(x_all[:, -n:]).to(cuda)
    hinv = trpiq._block_curvature_inv(x, t(hd).to(cuda), None, None,
                                      block_size=bs, exact_gram=True)
    args = (want[0], x @ wt.transpose(1, 2), x,
            hinv.reshape(b, in_dim, bs),
            want[1].repeat_interleave(g, -1),
            want[2].repeat_interleave(g, -1))
    rkw = dict(bits=4, block_size=bs, alpha=0.1, t_max=4, symmetric=False)
    want_r = tref.rpiq_block(*args, **rkw)
    got_r = tops.rpiq_block_cuda(*args, **rkw)
    assert_cells_close(got_r[0].cpu(), want_r[0].cpu())
    assert_cells_close(got_r[1].cpu(), want_r[1].cpu())
    assert float((got_r[2] - want_r[2]).norm() / want_r[2].norm()) <= 1e-4
    assert_rel(got_r[3].cpu(), want_r[3].cpu(), 1e-5)
    assert_rel(got_r[4].cpu(), want_r[4].cpu(), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s,kv_block,r", [(545, 128, 2), (4096, 64, 2),
                                          (300, 32, 8), (130, 128, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention(cuda, s, kv_block, r, dtype):
    rng = np.random.RandomState(8)
    args = [t(a).to(cuda) for a in kv_case(rng, b=4, s=s, kv=8, r=r,
                                           hd=128, kv_block=kv_block)]
    args[0] = args[0].to(dtype)
    want = tref.int8_kv_attention(*args, kv_block).float()
    got = tops.int8_kv_attention_cuda(*args, kv_block).float()
    assert float(got[-1].abs().max()) == 0.0
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,g", [(2048, 8192, 128), (8192, 2048, 128),
                                   (96, 64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_quant_pack(cuda, n, k, g, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + k)
    scales = torch.exp2(torch.randint(-8, -4, (n, k // g), generator=gen,
                                      device=cuda).float())
    zeros = torch.randint(0, 16, (n, k // g), generator=gen,
                          device=cuda).float()
    s_full = scales.repeat_interleave(g, dim=1)
    ties = (torch.randint(-12, 12, (n, k), generator=gen, device=cuda)
            + 0.5) * s_full
    free = torch.randn((n, k), generator=gen, device=cuda) * 8 * s_full
    w = torch.where(torch.rand((n, k), generator=gen, device=cuda) < 0.5,
                    ties, free).to(dtype)
    want = tref.quant_pack(w, scales, zeros, g)
    got = tops.quant_pack_cuda(w, scales, zeros, g)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n", [(4, 512, 8192, 16), (4, 77, 8192, 16),
                                     (1, 128, 8192, 16), (2, 33, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_selective_scan(cuda, b, s, d, n, dtype):
    rng = np.random.RandomState(9)
    args = [t(a).to(cuda) for a in scan_case(rng, b, s, d, n)]
    args[0] = args[0].to(dtype)
    y_want, h_want = tref.selective_scan(*args)
    y_got, h_got = tops.selective_scan_cuda(*args)
    assert y_got.dtype == dtype and h_got.dtype == torch.float32
    assert float((h_got - h_want).abs().max()) <= 1e-5 * float(
        h_want.abs().max())
    diff = (y_got.float() - y_want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(y_want.abs().max())
    else:
        assert np.all(diff.cpu().numpy()
                      <= bf16_ulp(y_want.float().cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(8192 + 32, 16), (128, 17)],
                         ids=["d-not-a-tile-multiple", "n-above-limit"])
def test_gpu_selective_scan_rejects_shapes_it_does_not_take(cuda, d, n):
    rng = np.random.RandomState(10)
    args = [t(a).to(cuda) for a in scan_case(rng, 1, 8, d, n)]
    tops.reset_kernel_launches()
    with pytest.raises(ValueError, match="selective_scan"):
        tops.selective_scan(*args)
    assert tops.kernel_launches()["selective_scan"] == 0

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
in bf16, and a shape the kernel does not take raises; ``w4a16_matmul``'s
bf16 tensor-core kernel within one bf16 ulp at groups 8, 16, 64 and 128,
the CUDA-core kernel within 1e-5 in fp32 (to k 12288) and one bf16 ulp at
the other even groups, and a launch that splits k over blocks bitwise
repeatable; ``int8_kv_attention`` launched twice bitwise equal.
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


@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("lead", [(3, 1), (2, 8)], ids=["decode", "prefill"])
def test_w4a16_small_groups_match_jax(g, lead):
    """The group sizes of the smoke configs (opt-proxy 16, internlm2 and
    falcon-mamba 8) in bf16, the serving dtype: the plain version within
    one bf16 ulp of the JAX oracle and of its Pallas and XLA paths."""
    rng = np.random.RandomState(13 + g)
    packed, scales, zeros, g = _w4a16_case(rng, n=192, k=256, g=g)
    x = rng.randn(*lead, 256).astype(np.float32)
    xt = t(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = tops.w4a16_matmul(xt, t(packed), t(scales), t(zeros),
                            group_size=g)
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, 192)
    got = got.float().numpy()
    args = (jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(zeros))
    wants = [jref.w4a16_matmul_ref(xj.reshape(-1, 256), *args,
                                   g).reshape(*lead, -1)]
    wants += [jops.w4a16_matmul(xj, *args, group_size=g, impl=impl)
              for impl in ("pallas", "xla")]
    for want in wants:
        want = np.asarray(want.astype(jnp.float32))
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


@pytest.mark.parametrize("bs", [256, 512], ids=["bs256", "bs-in"])
def test_gptq_block_wide_blocksize_matches_jax(bs):
    """Lazy blocks wider than 128 columns (the reference takes any
    blocksize dividing in that the group size divides): 256, and the
    whole row, at the pins of test_gptq_block_matches_jax."""
    rng = np.random.RandomState(12)
    b, out_dim, in_dim, g = 2, 40, 512, 64
    _, _, u = _hessian_case(rng, b, 600, in_dim)
    w = (rng.randn(b, out_dim, in_dim) * in_dim ** -0.5).astype(np.float32)
    kw = dict(bits=4, group_size=g, blocksize=bs, symmetric=False)
    got = [o.numpy() for o in tops.gptq_block(t(w), t(u), **kw)]
    wants = [jref.gptq_block_ref(w, u, **kw)]
    wants += [jops.gptq_block(jnp.asarray(w), jnp.asarray(u), impl=impl,
                              **kw) for impl in ("pallas", "xla")]
    for want in wants:
        w_q, scales, zeros, err = (np.asarray(a) for a in want)
        assert_cells_close(got[0], w_q)
        assert_cells_close(got[1], scales)
        assert_cells_close(got[2], zeros)
        assert_rel(got[3], err, 1e-5)


@pytest.mark.parametrize("bs", [256, 512], ids=["bs256", "bs-in"])
def test_rpiq_block_wide_blocksize_matches_jax(bs):
    """Column blocks wider than 128 columns, at the pins of
    test_rpiq_block_matches_jax (its problem, 512 columns wide)."""
    rng = np.random.RandomState(13)
    b, out_dim, in_dim, n, g, t_max, alpha = 2, 40, 512, 256, 64, 4, 0.1
    x_all, hd, u = _hessian_case(rng, b, 1024, in_dim)
    x_last = x_all[:, -n:]
    w_fp = (rng.randn(b, out_dim, in_dim) * 0.1).astype(np.float32)
    w0, scales, zeros, _ = (np.asarray(a) for a in jref.gptq_block_ref(
        w_fp, u, bits=4, group_size=g, blocksize=bs))
    h_count = np.full((b,), 1024, np.int32)
    x_count = np.full((b,), n, np.int32)
    kw = dict(bits=4, group_size=g, block_size=bs, alpha=alpha, t_max=t_max,
              early_stop=True, exact_gram=False)
    got = [a.numpy() for a in trpiq.rpiq_refine_batched(
        t(w0), t(w_fp), t(x_last), t(hd), t(scales), t(zeros),
        h_count=t(h_count), x_count=t(x_count), **kw)]
    jargs = [jnp.asarray(a) for a in (w0, w_fp, x_last, hd, scales, zeros)]
    jkw = dict(h_count=jnp.asarray(h_count), x_count=jnp.asarray(x_count),
               **kw)
    for impl in ("pallas", "xla"):
        w_q, w_cont, hist, ploss, iters = (np.asarray(a) for a in
                                           jrpiq.rpiq_refine_batched(
                                               *jargs, impl=impl, **jkw))
        assert_cells_close(got[0], w_q)
        assert_rel(got[2], hist, 1e-5)
        assert_rel(got[3], ploss, 1e-5)
        np.testing.assert_array_equal(got[4], iters)
        if impl == "pallas":
            assert_cells_close(got[1], w_cont)


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


# the phase-3 shapes of the three main paths (opt-proxy, internlm2-1.8b,
# falcon-mamba-7b): hessian_accum's d at n 512, rpiq_block's groups
HESSIAN_DS = (256, 768, 2048, 3072, 4096, 8192)
RPIQ_GROUPS = ((4, 768, 768), (1, 3072, 768), (1, 768, 3072),
               (1, 2048, 2048), (2, 1024, 2048), (2, 8192, 2048),
               (1, 2048, 8192), (1, 16384, 4096), (1, 288, 8192),
               (1, 8192, 256), (1, 4096, 8192))


@pytest.mark.parametrize("d", HESSIAN_DS)
def test_hessian_accum_geometry_fills_the_card(d):
    """Each 64 x 64 upper tile takes `split` blocks (at least two 32-token
    slabs a block), enough to give every SM two blocks where 8-block
    clusters can, and no more."""
    split = tops.hessian_accum_geometry(512, d)
    assert split in (1, 2, 4, 8) and 512 // split >= 64
    nt = -(-d // 64)
    tiles = nt * (nt + 1) // 2
    assert tiles * split >= min(2 * tops.SMS, tiles * 8)
    assert split == 1 or tiles * split // 2 < 2 * tops.SMS


@pytest.mark.parametrize("b,out_dim,in_dim", RPIQ_GROUPS)
def test_rpiq_block_geometry_fills_the_card(b, out_dim, in_dim):
    """At least half the SMs get a block wherever 8-block clusters could
    give them one; a group that fills half the card takes no cluster."""
    split = tops.rpiq_block_geometry(b, out_dim, 512)
    assert split in (1, 2, 4, 8)
    tiles = b * -(-out_dim // tops.RPIQ_ROWS)
    assert tiles * split >= min(tops.SMS // 2, tiles * 8)
    assert split == 1 or tiles * split // 2 < tops.SMS // 2


# w4a16_matmul's (k, n) on the three main paths: opt-proxy's three,
# internlm2-1.8b's four, falcon-mamba-7b's in, x, dt and out
W4A16_KN = ((768, 768), (768, 3072), (3072, 768), (2048, 2048),
            (2048, 1024), (2048, 8192), (8192, 2048), (4096, 16384),
            (8192, 288), (256, 8192), (8192, 4096))


@pytest.mark.parametrize("k,n", W4A16_KN)
@pytest.mark.parametrize("m", [4, 64, 2048], ids=["decode", "m64",
                                               "prefill"])
def test_w4a16_geometry_fills_the_card(m, k, n):
    """Every SM gets a block (four at decode), or k is split down to one
    quant group a block where it cannot; every split covers whole groups,
    the last one at least one, and a launch that fills the card is not
    split."""
    g = 128
    tile_m, tile_n, splits, cols = tops.w4a16_matmul_geometry(m, n, k, g)
    assert (tile_m, tile_n) == {4: (8, 64), 64: (16, 64),
                                2048: (64, 128)}[m]
    assert cols % g == 0 and (splits - 1) * cols < k <= splits * cols
    tiles = -(-n // tile_n) * -(-m // tile_m)
    want = tops.w4a16_blocks_wanted(tile_m)
    assert want >= tops.SMS
    assert tiles * splits >= want or cols == g
    assert splits == 1 or tiles < want


@pytest.mark.parametrize("k,n", W4A16_KN + ((64, 192), (128, 64)))
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("m", [4, 64, 2048], ids=["decode", "m64",
                                               "prefill"])
def test_w4a16_geometry_takes_small_groups(m, g, k, n):
    """Groups of 8 and 16 take the tensor cores; a split of k covers whole
    32-column blocks (the 16-byte copies) and so whole groups, the last
    one at least one block, and fills the card as at group 128."""
    assert tops.w4a16_tensor_core_group(g)
    tile_m, tile_n, splits, cols = tops.w4a16_matmul_geometry(m, n, k, g)
    assert (tile_m, tile_n) == {4: (8, 64), 64: (16, 64),
                                2048: (64, 128)}[m]
    assert cols % 32 == 0 and cols % g == 0
    assert (splits - 1) * cols < k <= splits * cols
    tiles = -(-n // tile_n) * -(-m // tile_m)
    want = tops.w4a16_blocks_wanted(tile_m)
    assert tiles * splits >= want or cols == 32
    assert splits == 1 or tiles < want


@pytest.mark.parametrize("g,tensor_cores", [
    (2, False), (4, False), (6, False), (8, True), (16, True), (24, False),
    (32, True), (48, False), (64, True), (96, False), (128, True),
    (256, True), (384, True)])
def test_w4a16_group_route(g, tensor_cores):
    """Which kernel bf16 x takes: the tensor cores at groups of 8, 16, 32,
    64 and multiples of 128, the CUDA cores at every other even group."""
    assert tops.w4a16_tensor_core_group(g) == tensor_cores


# the (B, KV) cells of internlm2-1.8b's decode (4 requests x 8 kv-heads),
# one request, and a batch of 16
KV_CELLS = ((4, 8), (1, 8), (16, 8))


@pytest.mark.parametrize("s", [1, 77, 128, 129, 545, 1000, 4096, 4097,
                               32768])
@pytest.mark.parametrize("b,kv", KV_CELLS)
def test_int8_kv_attention_geometry_fills_the_card(b, kv, s):
    """Ranges of whole 128-slot tiles, none empty, one at S <= 128; the
    blocks fill every SM wherever the tiles allow it, and a range is as
    short as two blocks an SM allow."""
    splits, per = tops.int8_kv_attention_geometry(b, kv, s)
    tiles = -(-s // tops.KV_TILE)
    cells = b * kv
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    if s <= tops.KV_TILE:
        assert splits == 1
    assert cells * splits >= min(tops.SMS, cells * tiles)
    if per > 1:
        assert cells * -(-tiles // (per - 1)) > 2 * tops.SMS


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("arch", ["opt-proxy", "internlm2-1.8b",
                                  "falcon-mamba-7b"])
def test_packed_zeros_are_integers_on_the_code_grid(arch, symmetric):
    """The contract bf16 w4a16_matmul's exact tensor-core products rest
    on: every zero of a packed artifact is an integer in [0, 15], so
    c - z is an integer in [-15, 15], exact in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.core.quant import quantized_leaves
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as TT

    cfg = get_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    cfg.quant.symmetric = symmetric
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cpu")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7),
                                3, 4, 32)
    params_q, _ = quantize_model(cfg, params, calib, device="cpu")
    leaves = list(quantized_leaves(pack_for_serving(cfg, params_q)
                                   ["layers"]))
    assert leaves
    for path, qt in leaves:
        z = qt.zeros
        assert bool(torch.isfinite(z).all()), path
        assert torch.equal(z, torch.round(z)), path
        assert float(z.min()) >= 0.0 and float(z.max()) <= 15.0, path


@pytest.mark.parametrize("out_dim", [48, 40, 72, 64])
def test_rpiq_pad_rows_adds_nothing(out_dim):
    """The kernel path's row padding: padded to a multiple of the row tile,
    the plain version's trajectory sliced back to the input's rows is the
    unpadded one, and the padded rows add nothing to Γ or the losses."""
    rng = np.random.RandomState(12)
    b, in_dim, n, g, bs = 2, 128, 64, 64, 64
    rows = tops.RPIQ_ROWS
    x = t(rng.randn(b, n, in_dim).astype(np.float32))
    w = t((rng.randn(b, out_dim, in_dim) * 0.1).astype(np.float32))
    s = t((rng.rand(b, out_dim, in_dim // g) * 0.02 + 0.01)
          .astype(np.float32)).repeat_interleave(g, -1)
    z = t(rng.randint(0, 16, (b, out_dim, in_dim // g)).astype(np.float32)
          ).repeat_interleave(g, -1)
    hinv = torch.eye(bs).repeat(b, in_dim // bs, 1) / n
    y = x @ w.transpose(1, 2)
    padded = tops.rpiq_pad_rows(w, y, s, z, rows)
    out_pad = -(-out_dim // rows) * rows
    assert padded[0].shape == (b, out_pad, in_dim)
    assert padded[1].shape == (b, n, out_pad)
    kw = dict(bits=4, block_size=bs, alpha=0.1, t_max=3, symmetric=False)
    want = tref.rpiq_block(w, y, x, hinv, s, z, **kw)
    got = tref.rpiq_block(padded[0], padded[1], x, hinv, padded[2],
                          padded[3], **kw)
    torch.testing.assert_close(got[0][:, :out_dim], want[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(got[1][:, :, :out_dim], want[1], rtol=0,
                               atol=0)
    assert int(torch.count_nonzero(got[0][:, out_dim:])) == 0
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[4], want[4], rtol=1e-6, atol=0)


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
@pytest.mark.parametrize("n,d", [(512, 256), (300, 200), (77, 102),
                                 (512, 2048)])
def test_gpu_hessian_accum_geometry_and_determinism(cuda, n, d):
    """d 256 takes 8-block clusters, (300, 200) 4-block ones; a ragged n
    and d mask the slab and panel edges (d 102 also takes the 4-byte
    copies of rows that are not 16-byte aligned); d 2048 one block per
    tile. Two launches on the same inputs give bitwise the same H."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * d)
    x = torch.randn(n, d, device=cuda, generator=gen)
    H = torch.randn(d, d, device=cuda, generator=gen)
    H = H + H.T
    want = tref.hessian_accum(x, H)
    got = tops.hessian_accum_cuda(x, H.clone())
    again = tops.hessian_accum_cuda(x, H.clone())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, again)
    assert torch.equal(got, got.T)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 300])
def test_gpu_rpiq_narrow_group_takes_the_cluster_split(cuda, n):
    """A 48-row group: padded to two 32-row tiles (ops.rpiq_pad_rows), the
    tokens split over an 8-block cluster, held against the plain version
    on the unpadded rows at the pins of test_gpu_gptq_and_rpiq."""
    rng = np.random.RandomState(11)
    b, out_dim, in_dim, g, bs = 1, 48, 256, 128, 128
    assert tops.rpiq_block_geometry(b, out_dim, n) == 8
    x_all, hd, u = _hessian_case(rng, b, 512, in_dim)
    w = (rng.randn(b, out_dim, in_dim) * in_dim ** -0.5).astype(np.float32)
    wt, ut = t(w).to(cuda), t(u).to(cuda)
    w0, scales, zeros, _ = tref.gptq_block(wt, ut, bits=4, group_size=g,
                                           blocksize=bs, symmetric=False)
    x = t(x_all[:, -n:]).to(cuda)
    hinv = trpiq._block_curvature_inv(x, t(hd).to(cuda), None, None,
                                      block_size=bs, exact_gram=True)
    args = (w0, x @ wt.transpose(1, 2), x, hinv.reshape(b, in_dim, bs),
            scales.repeat_interleave(g, -1), zeros.repeat_interleave(g, -1))
    rkw = dict(bits=4, block_size=bs, alpha=0.1, t_max=4, symmetric=False)
    want_r = tref.rpiq_block(*args, **rkw)
    w0p, yop, sp, zp = tops.rpiq_pad_rows(args[0], args[1], args[4],
                                          args[5], tops.RPIQ_ROWS)
    got_r = tops.rpiq_block_cuda(w0p, yop, args[2], args[3], sp, zp, **rkw)
    assert_cells_close(got_r[0][:, :out_dim].cpu(), want_r[0].cpu())
    assert_cells_close(got_r[1][:, :, :out_dim].cpu(), want_r[1].cpu())
    yq = got_r[2][..., :out_dim]
    assert float((yq - want_r[2]).norm() / want_r[2].norm()) <= 1e-4
    assert_rel(got_r[3].cpu(), want_r[3].cpu(), 1e-5)
    assert_rel(got_r[4].cpu(), want_r[4].cpu(), 1e-5)


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
@pytest.mark.parametrize("n", [256, 2048, 32768])
def test_gpu_gptq_and_rpiq(cuda, n):
    """rpiq_block splits the tokens over an 8-block cluster here, so each
    block keeps its share of the running Y_q in shared memory up to n 2048
    (256 tokens a block) and beyond; at n = 32768 (4096 a block) the share
    exceeds shared memory and the kernel keeps Y_q in the y_q output."""
    from repro_torch.kernels import build
    rng = np.random.RandomState(7)
    b, out_dim, in_dim, g, bs = 2, 96, 256, 64, 128
    split = tops.rpiq_block_geometry(b, out_dim, n)
    in_smem = build.load("rpiq_block").rpiq_block_yq_in_smem(
        n, bs, tops.RPIQ_ROWS, split)
    assert split == 8
    assert in_smem == (0 if n == 32768 else 1)
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
                                          (300, 32, 8), (130, 128, 1),
                                          (77, 128, 2), (4096, 128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention(cuda, s, kv_block, r, dtype):
    """One history range (S 77) and many (S 545: 5, S 4096: 8 ranges of
    whole tiles); the last lane has no valid slot and returns 0; a
    second launch is bitwise the first (the ranges combine in order)."""
    rng = np.random.RandomState(8)
    args = [t(a).to(cuda) for a in kv_case(rng, b=4, s=s, kv=8, r=r,
                                           hd=128, kv_block=kv_block)]
    args[0] = args[0].to(dtype)
    want = tref.int8_kv_attention(*args, kv_block).float()
    got = tops.int8_kv_attention_cuda(*args, kv_block)
    assert torch.equal(got, tops.int8_kv_attention_cuda(*args, kv_block))
    got = got.float()
    assert float(got[-1].abs().max()) == 0.0
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kv_block,r,s", [(16, 16, 2, 40), (64, 32, 4, 300),
                                             (256, 64, 8, 700),
                                             (48, 16, 3, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention_head_dims(cuda, hd, kv_block, r, s, dtype):
    """Head widths other than the serving 128: the smoke configs' 16, 64,
    256 (two value quads a lane) and 48 (a row of 12 words), at the pins of
    test_gpu_int8_kv_attention, bitwise repeatable."""
    rng = np.random.RandomState(hd + r)
    args = [t(a).to(cuda) for a in kv_case(rng, b=2, s=s, kv=3, r=r, hd=hd,
                                           kv_block=kv_block)]
    args[0] = args[0].to(dtype)
    want = tref.int8_kv_attention(*args, kv_block).float()
    got = tops.int8_kv_attention_cuda(*args, kv_block)
    assert torch.equal(got, tops.int8_kv_attention_cuda(*args, kv_block))
    got = got.float()
    assert float(got[-1].abs().max()) == 0.0
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [600, 1, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention_empty_ranges(cuda, valid, dtype):
    """A 4096-slot cache holding only its first `valid` slots, as a long
    preallocated cache does early in decode: every range past them holds
    only -1 slots and must add nothing (m -1e30, l 0), at the pins of
    test_gpu_int8_kv_attention; with no valid slot every lane returns 0."""
    rng = np.random.RandomState(14)
    s, kv_block = 4096, 128
    assert tops.int8_kv_attention_geometry(4, 8, s)[0] > 1
    args = [t(a).to(cuda) for a in kv_case(rng, b=4, s=s, kv=8, r=2,
                                           hd=128, kv_block=kv_block)]
    args[0] = args[0].to(dtype)
    args[5][:, valid:] = -1
    want = tref.int8_kv_attention(*args, kv_block).float()
    got = tops.int8_kv_attention_cuda(*args, kv_block)
    assert torch.equal(got, tops.int8_kv_attention_cuda(*args, kv_block))
    got = got.float()
    assert bool(torch.isfinite(got).all())
    empty = ~(args[5] >= 0).any(dim=1)
    assert bool(empty.any()) and int(torch.count_nonzero(got[empty])) == 0
    if not valid:
        assert int(torch.count_nonzero(got)) == 0
        return
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,g", [(2048, 8192, 128), (8192, 2048, 128),
                                   (96, 64, 8), (8192, 256, 128),
                                   (288, 8192, 128), (16384, 4096, 128),
                                   (37, 8200, 8)])
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
                                     (1, 128, 8192, 16), (2, 33, 128, 8),
                                     (2, 1, 64, 16), (3, 50, 192, 5),
                                     (1, 19, 128, 1), (2, 300, 256, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_selective_scan(cuda, b, s, d, n, dtype):
    """State counts 1, 5, 8 and 16 (a channel's two lanes hold up to eight
    states each, the second lane none at n <= 8), S ragged against the
    32-step tile (1, 19, 33, 50, 77, 300) and the serving shapes."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("g", [8, 16, 64, 128])
@pytest.mark.parametrize("k", [256, 8192, 12288])
@pytest.mark.parametrize("n", [288, 8192])
@pytest.mark.parametrize("m", [4, 77, 2048])
def test_gpu_w4a16_tensor_cores(cuda, m, n, k, g, symmetric):
    """bf16 x on the tensor-core kernel: decode, ragged and prefill m, the
    narrow and wide n, k past the earlier 8192 limit, the group sizes of
    the full-size paths (64, 128) and of the smoke configs (8, 16: the
    m16n8k8 steps) and both grids, within one bf16 ulp of the plain
    version; a launch that splits k is bitwise repeatable."""
    from repro_torch.core.quant import pack_quantized
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m * n + k + g)
    w = torch.randn((n, k), generator=gen, device=cuda) * k ** -0.5
    qt = pack_quantized(w, 4, g, symmetric=symmetric)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    args = (qt.packed, qt.scales, qt.zeros, g)
    want = tref.w4a16_matmul(x, *args).float()
    got = tops.w4a16_matmul_cuda(x, *args)
    diff = (got.float() - want).abs().cpu().numpy()
    assert np.all(diff <= bf16_ulp(want.cpu().numpy()))
    if tops.w4a16_matmul_geometry(m, n, k, g)[2] > 1:
        assert torch.equal(got, tops.w4a16_matmul_cuda(x, *args))


@pytest.mark.gpu
@pytest.mark.parametrize("k,g", [(12288, 128), (12288, 24), (96, 6),
                                 (768, 4)])
@pytest.mark.parametrize("m", [4, 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_w4a16_cuda_cores(cuda, dtype, m, k, g):
    """The CUDA-core kernel: fp32 x past 8192 columns (x staged in 8192-
    column chunks) within 1e-5 of the largest output, and bf16 x at even
    group sizes the tensor cores do not take (4, 6, 24) within one bf16
    ulp; k 12288 at group 128 in bf16 takes the tensor cores."""
    from repro_torch.core.quant import pack_quantized
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + k + g)
    n = 288
    w = torch.randn((n, k), generator=gen, device=cuda) * k ** -0.5
    qt = pack_quantized(w, 4, g, symmetric=False)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    args = (qt.packed, qt.scales, qt.zeros, g)
    want = tref.w4a16_matmul(x, *args).float()
    got = tops.w4a16_matmul_cuda(x, *args)
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got.float() - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dim,in_dim", [(288, 8192), (203, 512)],
                         ids=["x-projection", "ragged-rows"])
def test_gpu_gptq_block_rows(cuda, out_dim, in_dim):
    """falcon-mamba-7b's 288-row group, and a row count that is a multiple
    of neither the sweep's rows a block nor the tail's 64-row tile, held
    against the plain version at the pins of test_gpu_gptq_and_rpiq."""
    from repro_torch.core import hessian as thess
    gen = torch.Generator(device=cuda)
    gen.manual_seed(out_dim + in_dim)
    x = torch.randn((1, 512, in_dim), generator=gen, device=cuda)
    count = torch.full((1,), 512, dtype=torch.int32, device=cuda)
    hd = thess.damped(thess.HessianState(x.transpose(1, 2) @ x, count),
                      torch.full((1,), 0.01, device=cuda))
    u = thess.cholesky_inverse_upper(hd)
    w = torch.randn((1, out_dim, in_dim), generator=gen, device=cuda) \
        * in_dim ** -0.5
    kw = dict(bits=4, group_size=128, blocksize=128, symmetric=False)
    want = tref.gptq_block(w, u, **kw)
    got = tops.gptq_block_cuda(w, u, **kw)
    for a, b_ in zip(got[:3], want[:3]):
        assert_cells_close(a.cpu(), b_.cpu())
    e_got, e_want = float(got[3].sum()), float(want[3].sum())
    assert abs(e_got - e_want) <= 1e-3 * abs(e_want)


def _group_on_card(gen, b, out_dim, in_dim, n, gs, bs):
    """A stacked group on n tokens drawn from gen, as chip_smoke.py phase 3
    builds it: the plain version's stage-1 result and rpiq_block's
    inputs."""
    from repro_torch.core import hessian as thess
    dev = torch.device("cuda")
    x = torch.randn((b, n, in_dim), generator=gen, device=dev)
    w = torch.randn((b, out_dim, in_dim), generator=gen, device=dev) \
        * in_dim ** -0.5
    count = torch.full((b,), n, dtype=torch.int32, device=dev)
    hd = thess.damped(thess.HessianState(x.transpose(1, 2) @ x, count),
                      torch.full((b,), 0.01, device=dev))
    u = thess.cholesky_inverse_upper(hd)
    kw = dict(bits=4, group_size=gs, blocksize=bs, symmetric=False)
    w0, scales, zeros, _ = tref.gptq_block(w, u, **kw)
    hinv = trpiq._block_curvature_inv(x, hd, count, count, block_size=bs,
                                      exact_gram=False)
    rargs = (w0, x @ w.transpose(1, 2), x,
             hinv.reshape(b, in_dim, bs).contiguous(),
             scales.repeat_interleave(gs, -1),
             zeros.repeat_interleave(gs, -1))
    return w, u, kw, rargs


def _assert_rpiq_pins(rargs, bs, t_max=5, alpha=0.01, cross_gamma=True,
                      cross_yq=True):
    """rpiq_block against its plain version at chip_smoke.py phase 3's
    pins: selected weights, candidates and w_cont cells differing > 1e-6
    at most 1e-3; final Y_q 1e-4 rel; Gamma within 1e-5 rel (times
    sqrt(768 x 512 / (out x n)) below that many cells); the projected
    loss 1e-5 rel; iterations equal; each side's last-round Gamma within
    1e-6 of the fp64 Gamma of its own w_cont. ``cross_gamma`` /
    ``cross_yq`` False: Gamma / Y_q against the plain version's not held
    (they follow the two iterates; see test_gpu_rpiq_over_seeds and
    test_gpu_gptq_and_rpiq_wide_blocksizes)."""
    w0, y_orig, x = rargs[:3]
    _, out_dim, _ = w0.shape
    n = x.shape[1]
    rkw = dict(bits=4, block_size=bs, alpha=alpha, t_max=t_max,
               symmetric=False)
    want = tref.rpiq_block(*rargs, **rkw)
    got = tops.rpiq_block_cuda(*rargs, **rkw)
    sel = [tops._rpiq_select(r[3], r[4], r[1], t_max, True)
           for r in (got, want)]
    assert_cells_close(sel[0][0].cpu(), sel[1][0].cpu())
    assert_cells_close(got[1].cpu(), want[1].cpu())
    assert_cells_close(got[0].cpu(), want[0].cpu())
    if cross_yq:
        assert float((got[2] - want[2]).norm() / want[2].norm()) <= 1e-4
    g_tol = 1e-5 * max(1.0, (768 * 512 / (out_dim * n)) ** 0.5)
    if cross_gamma:
        assert_rel(got[3].cpu(), want[3].cpu(), g_tol)
    assert_rel(got[4].cpu(), want[4].cpu(), 1e-5)
    assert torch.equal(sel[0][3], sel[1][3])
    x64, y64 = x.double(), y_orig.double()
    for side in (got, want):
        g64 = ((y64 - x64 @ side[0].double().transpose(1, 2)) ** 2).sum(
            (1, 2))
        assert float(((side[3][:, t_max].double() - g64).abs()
                      / g64).max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("b,out_dim,in_dim", [(1, 288, 8192), (4, 768, 768)],
                         ids=["falcon-x", "opt-proxy"])
def test_gpu_rpiq_over_seeds(cuda, b, out_dim, in_dim, seed):
    """The two narrowest phase-3 groups on eight instances, each from a
    generator of its own: the kernel sums Gamma and the projected loss in
    fp64, so its Gamma sits within 1e-6 of its own iterate's exact value
    on every instance. At the 288-row group the kernel's Gamma is not held
    to the plain version's: the two iterates (fp32 sums in different
    orders; the kernel's is bitwise the earlier kernel's) have exact
    Gammas up to 2.9e-5 apart there on these seeds, past that pin's
    1.63e-5 (chip_smoke.py kernels_rpiq_seeds)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    _, _, _, rargs = _group_on_card(gen, b, out_dim, in_dim, 512, 128, 128)
    _assert_rpiq_pins(rargs, 128, cross_gamma=out_dim != 288)


@pytest.mark.gpu
@pytest.mark.parametrize("b,out_dim,in_dim,gs,bs", [
    (4, 768, 768, 128, 256), (4, 768, 768, 128, 768),
    (1, 3072, 768, 128, 256), (1, 3072, 768, 128, 768),
    (1, 768, 3072, 128, 256), (1, 768, 3072, 128, 3072),
    (2, 96, 384, 6, 6), (2, 96, 408, 8, 136)],
    ids=["opt-qkv-256", "opt-qkv-in", "opt-up-256", "opt-up-in",
         "opt-down-256", "opt-down-in", "bs6", "bs136"])
def test_gpu_gptq_and_rpiq_wide_blocksizes(cuda, b, out_dim, in_dim, gs,
                                           bs):
    """Every blocksize the reference takes: lazy blocks wider than 128
    columns (256 and the whole row on opt-proxy's groups; 136) and ones
    whose rows are not 16-byte aligned (6), gptq_block at
    test_gpu_gptq_and_rpiq's pins and rpiq_block at phase 3's, but for Y_q
    and Gamma against the plain version's at blocksize = in: one solve
    over a whole row of 768 or 3072 columns rounds differently in the two
    orders, and the intermediate projections that flip by a grid step
    (within the w_cont pin) move Y_q by up to 3.4e-4 rel and Gamma by up
    to 8e-5 rel on these groups (chip_smoke.py kernels_blocksizes); each
    side's Gamma is still held to 1e-6 of its own iterate's exact
    Gamma."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(out_dim + in_dim + bs)
    w, u, kw, rargs = _group_on_card(gen, b, out_dim, in_dim, 512, gs, bs)
    want = tref.gptq_block(w, u, **kw)
    got = tops.gptq_block_cuda(w, u, **kw)
    for a, b_ in zip(got[:3], want[:3]):
        assert_cells_close(a.cpu(), b_.cpu())
    assert_rel(got[3].sum(-1).cpu(), want[3].sum(-1).cpu(), 1e-3)
    _assert_rpiq_pins(rargs, bs, cross_gamma=bs != in_dim,
                      cross_yq=bs != in_dim)


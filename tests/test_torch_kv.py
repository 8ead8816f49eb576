"""The port's int8 KV cache against the JAX package.

Same seeded numpy inputs through the JAX function and the port's:

- codec: ``kv_codec`` blocked encode/decode bitwise against
  ``repro.kernels.kv_codec`` (half-to-even ties, all-zero rows, 1, 2 and 4
  blocks per row) and ``default_kv_block``;
- ``int8_kv_attention``: the plain version within 1e-5 (of the largest
  output) of the JAX oracle ``ref.int8_kv_attention_ref`` and of the Pallas
  kernel in interpret mode, at S not a multiple of 128, R in {1, 2, 4},
  with -1 holes and a lane with no valid slot. There the Pallas kernel and
  the port return 0 while the oracle's plain softmax spreads the lane
  uniformly over its invalid slots, so that lane is held against the
  kernel only;
- ``quant_pack``: the plain version bitwise against ``ref.quant_pack_ref``
  and the Pallas kernel, with w/s exactly on .5 ties;
- the GQA model with the int8 cache (internlm2 smoke, converted JAX
  weights): prefill logits equal to the bf16-cache prefill; the cache
  leaves after prefill + 3 decode steps against JAX's at model dtype
  float32 (codes differing in <= 1e-3 of the cells; scales, and the error
  accumulators, within 1e-5 of the largest scale and of the largest cached
  value, 127 x that scale: an accumulator is the small difference
  x - dec(enc(x)) and carries x's rounding); greedy tokens equal to the
  bf16 cache over 8 steps (at float32) and the JAX drift rule (bf16,
  per-step |Δlogit| <= 0.25, late half <= 3 x early half + 0.05), for
  opt-proxy and internlm2 smoke.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import kv_codec as jcodec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import QuantParams, pack_int4, quantize_codes
from repro_torch.data import MarkovLM
from repro_torch.kernels import kv_codec as tcodec
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import generate

from test_torch_kernels import kv_case
from test_torch_models import to_numpy


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 48, 64, 96, 128, 256])
def test_default_kv_block_matches_jax(hd):
    assert tcodec.default_kv_block(hd) == jcodec.default_kv_block(hd)


def _codec_input(rng, block, nb):
    """(4, 3, nb*block) rows: random, all-zero, and rows whose absmax makes
    the scale exactly 0.5 (63.5 / 127; the 1e-12 is below its ulp) so that
    x / scale lands on .5 ties."""
    d = nb * block
    x = (rng.randn(4, 3, d) * 3).astype(np.float32)
    x[1, 0] = 0.0
    ties = (rng.randint(-126, 126, size=(3, d)) + 0.5) * 0.5
    ties[:, ::block] = 63.5
    x[2] = ties.astype(np.float32)
    return x


@pytest.mark.parametrize("block,nb", [(128, 1), (64, 2), (32, 4), (16, 1)])
def test_codec_bitwise_against_jax(block, nb):
    x = _codec_input(np.random.RandomState(nb * block), block, nb)
    codes, scales = tcodec.enc_int8_blocks(t(x), block)
    jc, js = jcodec.enc_int8_blocks(jnp.asarray(x), block)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == (4, 3, nb)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    # the tie rows really tie, and round to even
    r = x[2] / scales.numpy()[2].repeat(block, axis=-1)
    tie = np.abs(r - np.trunc(r)) == 0.5
    assert tie.mean() > 0.5
    np.testing.assert_array_equal(codes.numpy()[2][tie] % 2, 0)
    np.testing.assert_array_equal(codes.numpy()[1, 0], 0)
    dec = tcodec.dec_int8_blocks(codes, scales, block)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jcodec.dec_int8_blocks(jc, js, block)))


# ---------------------------------------------------------------------------
# int8_kv_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("s,kv_block", [(200, 64), (75, 32)])
def test_int8_kv_attention_matches_jax(r, s, kv_block):
    rng = np.random.RandomState(r * 1000 + s)
    b, kv, hd = 3, 2, 64
    args = kv_case(rng, b, s, kv, r, hd, kv_block)
    got = tops.int8_kv_attention(*(t(a) for a in args), kv_block=kv_block)
    assert got.shape == (b, kv, r, hd) and got.dtype == torch.float32
    got = got.numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.int8_kv_attention(*jargs, kv_block=kv_block,
                                               impl="pallas"))
    oracle = np.asarray(jref.int8_kv_attention_ref(*jargs, kv_block))
    tol = 1e-5 * np.max(np.abs(pallas))
    assert np.max(np.abs(got - pallas)) <= tol
    # the lane with no valid slot is 0 on the kernel and the port
    np.testing.assert_array_equal(got[-1], 0.0)
    np.testing.assert_array_equal(pallas[-1], 0.0)
    assert np.max(np.abs(got[:-1] - oracle[:-1])) <= tol


def test_int8_kv_attention_bf16_query():
    """bf16 queries: fp32 inside, the output rounded once to bf16."""
    rng = np.random.RandomState(9)
    q, kc, ks, vc, vs, kpos = kv_case(rng, 2, 40, 2, 2, 32, 32)
    qb = t(q).to(torch.bfloat16)
    got = tops.int8_kv_attention(qb, t(kc), t(ks), t(vc), t(vs), t(kpos),
                                 kv_block=32)
    assert got.dtype == torch.bfloat16
    want = tops.int8_kv_attention(qb.float(), t(kc), t(ks), t(vc), t(vs),
                                  t(kpos), kv_block=32)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# quant_pack
# ---------------------------------------------------------------------------

def _quant_pack_case(rng, n, k, g, dtype):
    scales = (2.0 ** rng.randint(-6, -2, size=(n, k // g))).astype(
        np.float32)
    zeros = rng.randint(0, 16, size=(n, k // g)).astype(np.float32)
    s_full = np.repeat(scales, g, axis=1)
    # half the cells sit exactly on a .5 tie of w / s (powers-of-two
    # scales keep the product exact in bf16 too), some past the clip
    w = (rng.randint(-12, 12, size=(n, k)) + 0.5) * s_full
    free = rng.rand(n, k) < 0.5
    w[free] = (rng.randn(n, k) * 8 * s_full)[free]
    w = t(w.astype(np.float32)).to(getattr(torch, dtype))
    return w, scales, zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,g", [(64, 256, 64), (48, 96, 8)])
def test_quant_pack_bitwise_against_jax(dtype, n, k, g):
    rng = np.random.RandomState(n + k)
    w, scales, zeros = _quant_pack_case(rng, n, k, g, dtype)
    got = tops.quant_pack(w, t(scales), t(zeros), group_size=g)
    assert got.dtype == torch.uint8 and got.shape == (n, k // 2)
    wj = jnp.asarray(w.float().numpy()).astype(jnp.dtype(dtype))
    args = (wj, jnp.asarray(scales), jnp.asarray(zeros))
    for want in (jref.quant_pack_ref(*args, g),
                 jops.quant_pack(*args, group_size=g, impl="pallas")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the packer pack_for_serving used before: the same bytes
    codes = quantize_codes(w.float(), QuantParams(t(scales), t(zeros)), 4,
                           g)
    torch.testing.assert_close(got, pack_int4(codes), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the GQA model with the int8 cache
# ---------------------------------------------------------------------------

def _gqa_setup(dtype, arch="internlm2-1.8b"):
    jcfg = jget_config(arch, smoke=True)
    tcfg = tget_config(arch, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = dtype
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    toks = np.random.RandomState(0).randint(
        0, tcfg.model.vocab_size, size=(2, 12))
    return jcfg, tcfg, jparams, tparams, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_query_scale_rounds_as_jax(dtype):
    """hd^-0.5 at hd 128 is not a bf16 value: JAX rounds it to the array's
    dtype before the product, and so must the grouped decode query."""
    from repro_torch.models.attention import _prescaled_groups
    x = np.random.RandomState(4).randn(3, 16, 128).astype(np.float32)
    qj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = (qj * 128 ** -0.5).reshape(3, 8, 2, 128).astype(jnp.float32)
    got = _prescaled_groups(t(x).to(getattr(torch, dtype)), 8)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_convert_keeps_gqa_shapes():
    jcfg, tcfg, jparams, tparams, _ = _gqa_setup("float32")
    mc = tcfg.model
    assert (mc.num_heads, mc.num_kv_heads, mc.head_dim) == (4, 2, 16)
    seg = jparams["blocks"][0]["sub0"]["mixer"]
    for i, layer in enumerate(tparams["layers"]):
        for name, width in (("q", 4 * 16), ("k", 2 * 16), ("v", 2 * 16)):
            w = layer["mixer"][name]["w"]
            assert tuple(w.shape) == (mc.d_model, width)
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(seg[name]["w"][i]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_prefill_logits_equal_bf16_cache(dtype):
    _, tcfg, _, tparams, toks = _gqa_setup(dtype)
    lf, _ = TT.prefill(tcfg.model, tparams, t(toks), 16)
    lq, caches = TT.prefill(tcfg.model, tparams, t(toks), 16,
                            cache_dtype="int8")
    torch.testing.assert_close(lq, lf, rtol=0, atol=0)
    assert caches[0]["k"].dtype == torch.int8
    assert caches[0]["k_scale"].shape == (2, 16, 2, 1)


def test_int8_decode_cache_leaves_match_jax():
    jcfg, tcfg, jparams, tparams, toks = _gqa_setup("float32")
    _, cj = JT.prefill(jcfg.model, jparams, jnp.asarray(toks), 16,
                       cache_dtype="int8")
    _, ct = TT.prefill(tcfg.model, tparams, t(toks), 16,
                       cache_dtype="int8")
    nxt = np.random.RandomState(1).randint(0, 128, size=(3, 2))
    for i in range(3):
        pos = np.full((2,), 12 + i, np.int32)
        _, cj = JT.decode_step(jcfg.model, jparams, jnp.asarray(nxt[i]),
                               jnp.asarray(pos), cj)
        _, ct = TT.decode_step(tcfg.model, tparams, t(nxt[i]).long(),
                               t(pos).long(), ct)
    stacked = to_numpy(cj)[0]["sub0"]
    for li, cache in enumerate(ct):
        for leaf in ("k", "v"):
            want = stacked[leaf][li]
            got = cache[leaf].numpy()
            assert np.mean(got != want) <= 1e-3
            want_s = stacked[f"{leaf}_scale"][li]
            got_s = cache[f"{leaf}_scale"].numpy()
            assert np.max(np.abs(got_s - want_s)) <= 1e-5 * np.max(want_s)
            # the accumulator is x - dec(enc(x)), a difference of values
            # as large as 127 * scale: it carries their float rounding
            want_e = stacked[f"{leaf}_err"][li]
            got_e = cache[f"{leaf}_err"].numpy()
            assert np.max(np.abs(got_e - want_e)) <= 1e-5 * 127 * np.max(
                want_s)


@pytest.mark.parametrize("arch", ["opt-proxy", "internlm2-1.8b"])
def test_int8_cache_greedy_tokens_equal_bf16_cache(arch):
    """The JAX pinned horizon on the port, at model dtype float32: in bf16
    the two frameworks' rounding already moves near-tied greedy choices
    (the port's and JAX's bf16-cache runs of opt-proxy smoke part at
    step 4), which would hide what the int8 cache does."""
    _, tcfg, _, tparams, _ = _gqa_setup("float32", arch)
    toks = MarkovLM(tcfg.model.vocab_size, seed=0).batch(3, 8)["tokens"]
    r_fp = generate(tcfg, tparams, {"tokens": toks}, device="cpu",
                    max_new_tokens=8)
    tcfg.serve.kv_cache = "int8"
    r_q = generate(tcfg, tparams, {"tokens": toks}, device="cpu",
                   max_new_tokens=8)
    torch.testing.assert_close(r_q.tokens, r_fp.tokens, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["opt-proxy", "internlm2-1.8b"])
def test_int8_cache_drift_rule(arch):
    """The JAX drift contract on the port (bf16, as in JAX): both caches
    fed the same (bf16-chosen) token stream keep the per-step logit gap
    bounded and not growing."""
    _, tcfg, _, tparams, _ = _gqa_setup("bfloat16", arch)
    mc = tcfg.model
    toks = MarkovLM(mc.vocab_size, seed=0).batch(3, 8)["tokens"]
    b, s0 = toks.shape
    lg_f, c_f = TT.prefill(mc, tparams, toks, s0 + 14)
    _, c_q = TT.prefill(mc, tparams, toks, s0 + 14, cache_dtype="int8")
    tok = torch.argmax(lg_f, -1)
    pos = torch.full((b,), s0, dtype=torch.long)
    deltas = []
    for _ in range(12):
        lf, c_f = TT.decode_step(mc, tparams, tok, pos, c_f)
        lq, c_q = TT.decode_step(mc, tparams, tok, pos, c_q)
        deltas.append(float((lf - lq).abs().max()))
        tok = torch.argmax(lf, -1)
        pos = pos + 1
    assert max(deltas) <= 0.25, deltas
    assert max(deltas[6:]) <= 3 * max(deltas[:6]) + 0.05, deltas

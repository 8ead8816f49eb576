"""The other dense architectures of the port against the JAX package.

h2o-danube-1.8b (sliding-window attention on a ring cache), minicpm-2b
(tied embeddings), stablelm-1.6b (LayerNorm with biases) and pixtral-12b
(precomputed patch embeddings in front of the text), at their smoke
sizes, with the JAX package's initial weights carried across by
``convert.params_from_numpy`` and the same numpy inputs through both:

- configs: every field the port reads equals the JAX config's, full and
  smoke;
- ``forward`` and ``prefill`` + 3 decode steps, the cache in the model's
  dtype: relative Frobenius error ≤ 1e-5 at model dtype float32, ≤ 2e-2
  at bf16 (the frameworks round bf16 intermediates at different places;
  a bf16 cache under a float32 model rounds q and K/V to bf16 too, where
  an fp32 summation-order difference can flip one rounding: 1.75e-4 on
  stablelm smoke); pixtral with its 8 ``embeds``, h2o-danube with a
  12-token prompt past its window of 8 (the prefill keeps the last 8
  positions in the ring);
- the ring: 15 decode steps past the window against JAX's
  ``decode_step``, float32 (≤ 1e-5), bf16 (≤ 2e-2) and the int8 cache
  under a float32 model (≤ 1e-4: the two frameworks' K/V may round to
  neighbouring codes on a tie), and against the same weights on a
  full-length cache masked by the window (≤ 1e-5; bf16 ≤ 2e-2: the slots
  are summed in another order);
  ``cache_key_positions``' validity equal to JAX's ``kpos >= 0`` and
  every invalid slot -1 (the contract the JAX helper breaks, ROADMAP.md
  §3);
- quantize → pack → greedy generate at model dtype float32 from the same
  calibration stream (``MarkovLM(vocab, seed=7)``, 3 × 4 × 32, pixtral's
  batches with 8 seeded patch embeddings each), against JAX with
  ``quant.jit_capture=false``, at the pins of tests/test_torch_pipeline.py:
  record names and modes equal, ``iters_run`` equal, Γ ≤ 1e-3, packed
  codes differing in ≤ 1e-2 of the bytes, packed-model logits ≤ 1e-3; and
  ``generate`` on the JAX-packed weights (h2o-danube on the int8 ring)
  gives the JAX engine's tokens exactly;
- the soft caps: ``int8_kv_attention`` with ``softcap`` 0 and 30 (the
  plain version against JAX's Pallas kernel in interpret mode and its
  oracle, 1e-5 of the largest output), and ``attn_logits_softcap`` 30 with
  ``logits_softcap`` 20 through forward, prefill and decode (bf16 and int8
  cache) against JAX;
- ``gpu`` (skip without a card): the kernel at h2o-danube's head width 80
  (one scale block a row) on a wrapped ring's ``kpos``, with and without
  the soft cap, against its plain version.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.pipeline import pack_for_serving as jpack
from repro.core.pipeline import quantize_model as jquantize
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.pipeline import quantize_model as tquantize
from repro_torch.core.quant import (compute_qparams, pack_int4,
                                    quantize_codes, quantized_leaves)
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.kernels import kv_codec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.layers import unembed as tunembed
from repro_torch.serving import engine as tengine

from test_torch_kernels import bf16_ulp, kv_case
from test_torch_models import rel, to_numpy

ARCHS = ["h2o-danube-1.8b", "minicpm-2b", "stablelm-1.6b", "pixtral-12b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(a, d) for a in ARCHS for d in ("float32", "bfloat16")]
# the fields of the port's ModelConfig, all of them also JAX's
FIELDS = [f.name for f in dataclasses.fields(
    tget_config("opt-proxy").model)
    if f.name not in ("ssm", "moe", "mla", "rglru")]


def t(a):
    return torch.from_numpy(np.array(a))


def _front(mc, b, seed=11):
    """Seeded patch embeddings (B, frontend_tokens, D), or None."""
    if not mc.frontend_tokens:
        return None
    rng = np.random.RandomState(seed)
    return rng.randn(b, mc.frontend_tokens, mc.d_model).astype(np.float32)


def _setup(arch, dtype="float32", seed=0, **model):
    jcfg = jget_config(arch, smoke=True)
    tcfg = tget_config(arch, smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = dtype
        for k, v in model.items():
            setattr(cfg.model, k, v)
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(to_numpy(jparams))
    return jcfg, tcfg, jparams, tparams


def _both(a):
    """numpy → (jnp, torch); None stays None."""
    return (None, None) if a is None else (jnp.asarray(a), t(a))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    j, tc = jget_config(arch, smoke=smoke), tget_config(arch, smoke=smoke)
    for f in FIELDS + ["layer_kinds"]:
        assert getattr(tc.model, f) == getattr(j.model, f), f
    for sub in ("moe", "mla", "rglru"):
        assert dataclasses.asdict(getattr(tc.model, sub)) == \
            dataclasses.asdict(getattr(j.model, sub)), sub
    for f in ("bits", "group_size", "blocksize", "rpiq_iters", "rpiq_alpha"):
        assert getattr(tc.quant, f) == getattr(j.quant, f), f


def test_tied_tree_has_no_lm_head():
    jcfg, tcfg, jparams, tparams = _setup("minicpm-2b")
    assert "lm_head" not in jparams and "lm_head" not in tparams
    assert set(tparams) == set(jparams) - {"blocks"} | {"layers"}
    gen = torch.Generator()
    gen.manual_seed(0)
    assert "lm_head" not in TT.init_params(tcfg.model, gen, "cpu")
    # the head is the embedding: a hidden state equal to a row of it
    # scores that row highest
    emb = tparams["embed"]["embedding"]
    lg = tunembed(tcfg.model, tparams, emb[None, 5:6] * 50)
    assert int(lg.argmax()) == 5


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_logits(arch, dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    toks = np.random.RandomState(0).randint(0, 128, size=(2, 12))
    je, te = _both(_front(tcfg.model, 2))
    lj, _ = JT.forward(jcfg.model, jparams, jnp.asarray(toks), je)
    lt = TT.forward(tcfg.model, tparams, t(toks), te)
    n = 12 + tcfg.model.frontend_tokens
    assert lt.dtype == torch.float32 and lt.shape == (2, n, 128)
    assert rel(lt.numpy(), lj) <= TOL[dtype]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_decode_logits(arch, dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    mc = tcfg.model
    toks = np.random.RandomState(0).randint(0, 128, size=(2, 12))
    je, te = _both(_front(mc, 2))
    s0 = 12 + mc.frontend_tokens
    max_len = s0 + 4
    lj, cj = JT.prefill(jcfg.model, jparams, jnp.asarray(toks), max_len,
                        embeds=je, cache_dtype=jnp.dtype(dtype))
    lt, ct = TT.prefill(mc, tparams, t(toks), max_len, embeds=te,
                        cache_dtype=getattr(torch, dtype))
    assert rel(lt.numpy(), lj) <= TOL[dtype]
    if mc.window_size:          # the ring: the window, not the prompt
        assert ct[0]["k"].shape[1] == mc.window_size < s0
    nxt = np.random.RandomState(1).randint(0, 128, size=(3, 2))
    for i in range(3):
        pos = np.full((2,), s0 + i, np.int32)
        lj, cj = JT.decode_step(jcfg.model, jparams, jnp.asarray(nxt[i]),
                                jnp.asarray(pos), cj)
        lt, ct = TT.decode_step(mc, tparams, t(nxt[i]).long(),
                                t(pos).long(), ct)
        assert rel(lt.numpy(), lj) <= TOL[dtype]


def _ring_run(mc, params, toks, max_len, cache_dtype, decode, steps=15):
    """Prefill 4 tokens, then decode tokens 4 .. 4 + steps - 1; the
    per-step logits as numpy."""
    out = []
    lg, caches = decode["prefill"](mc, params, toks[:, :4], max_len,
                                   cache_dtype)
    for i in range(steps):
        lg, caches = decode["step"](mc, params, toks[:, 4 + i], 4 + i,
                                    caches)
        out.append(np.asarray(lg))
    return out, caches


JAX_RING = {
    "prefill": lambda mc, p, tk, n, cd: JT.prefill(
        mc, p, jnp.asarray(tk), n, cache_dtype=cd),
    "step": lambda mc, p, tok, pos, c: JT.decode_step(
        mc, p, jnp.asarray(tok), jnp.full((tok.shape[0],), pos, jnp.int32),
        c)}
PORT_RING = {
    "prefill": lambda mc, p, tk, n, cd: TT.prefill(
        mc, p, t(tk), n, cache_dtype=cd),
    "step": lambda mc, p, tok, pos, c: TT.decode_step(
        mc, p, t(tok).long(), torch.full((tok.shape[0],), pos), c)}


# (model dtype, cache) → (JAX cache dtype, port cache dtype, pin)
RING_LEGS = {("float32", "float32"): (jnp.float32, torch.float32, 1e-5),
             ("bfloat16", "bf16"): (jnp.bfloat16, torch.bfloat16, 2e-2),
             ("float32", "int8"): ("int8", "int8", 1e-4)}


@pytest.mark.parametrize("dtype,kv_cache", list(RING_LEGS),
                         ids=["float32", "bf16", "int8"])
def test_ring_decode_past_the_window(dtype, kv_cache):
    """15 decode steps from a 4-token prompt through a ring of 8 slots (it
    wraps at position 8 and again at 16), against JAX and against the
    port on a full-length cache masked by the window."""
    jcfg, tcfg, jparams, tparams = _setup("h2o-danube-1.8b", dtype, seed=1)
    mc = tcfg.model
    assert mc.window_size == 8
    toks = np.asarray(JMarkovLM(128, seed=6).batch(2, 20)["tokens"])
    jdt, tdt, tol = RING_LEGS[dtype, kv_cache]
    want, _ = _ring_run(jcfg.model, jparams, toks, 24, jdt, JAX_RING)
    got, caches = _ring_run(mc, tparams, toks, 24, tdt, PORT_RING)
    assert all(c["k"].shape[1] == 8 for c in caches)
    for g, w in zip(got, want):
        assert rel(g, w) <= tol
    # the same weights on a 24-slot cache: the window masks, nothing wraps
    orig = TT.init_layer_cache
    try:
        TT.init_layer_cache = lambda cfg, spec, b, n, dev, dt: \
            TA.init_kv_cache(cfg, b, n, dev, dt)
        flat, fcaches = _ring_run(mc, tparams, toks, 24, tdt, PORT_RING)
    finally:
        TT.init_layer_cache = orig
    assert all(c["k"].shape[1] == 24 for c in fcaches)
    for g, f in zip(got, flat):
        assert rel(g, f) <= TOL[dtype]


@pytest.mark.parametrize("cache_len,window", [(8, 8), (8, 16), (5, 16),
                                              (16, 0), (6, 4)])
def test_cache_key_positions_validity_matches_jax(cache_len, window):
    """Every slot after each ``last`` in [-1, 3 cache_len): valid exactly
    where JAX's ``kpos >= 0``, the valid slots holding JAX's positions,
    the rest -1; the decode step's ring formula agrees too."""
    lasts = np.arange(-1, 3 * cache_len)
    got = TA.cache_key_positions(t(lasts), cache_len, window).numpy()
    for last, row in zip(lasts, got):
        want = np.asarray(JA._cache_key_positions(int(last), cache_len,
                                                  window))
        np.testing.assert_array_equal(row >= 0, want >= 0)
        np.testing.assert_array_equal(row[row >= 0], want[want >= 0])
        assert np.all(row[row < 0] == -1)
        if window and last >= 0:          # written slots alias distinct p
            valid = row[row >= 0]
            assert len(set(valid)) == len(valid) <= min(window, cache_len)
            np.testing.assert_array_equal(valid % cache_len,
                                          np.nonzero(row >= 0)[0])


# ---------------------------------------------------------------------------
# quantize → pack → generate
# ---------------------------------------------------------------------------

KV_CACHE = {"h2o-danube-1.8b": "int8", "minicpm-2b": "fp16",
            "stablelm-1.6b": "fp16", "pixtral-12b": "fp16"}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jcfg.quant.jit_capture = False
    jcfg.serve.kv_cache = tcfg.serve.kv_cache = KV_CACHE[arch]
    jc = jcalib(JMarkovLM(128, seed=7), 3, 4, 32)
    tc = tcalib(TMarkovLM(128, seed=7), 3, 4, 32)
    for i, (a, b) in enumerate(zip(jc, tc)):
        e = _front(tcfg.model, 4, seed=20 + i)
        if e is not None:
            a["embeds"], b["embeds"] = _both(e)
    jq, jrep = jquantize(jcfg, jparams, jc)
    tq, trep = tquantize(tcfg, tparams, tc, device="cpu")
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jc=jc, tc=tc, jq=jq,
                jrep=jrep, tq=tq, trep=trep)


def test_quantize_report_matches(runs):
    jl, tl = runs["jrep"].linears, runs["trep"].linears
    assert [r.name for r in tl] == [r.name for r in jl]
    assert len(tl) == 2 * 7 and all(r.mode != "skipped" for r in tl)
    for a, b in zip(tl, jl):
        assert (a.mode, a.shape, a.iters) == (b.mode, tuple(b.shape),
                                              b.iters), a.name
        n = min(len(a.gamma), len(b.gamma))
        np.testing.assert_allclose(a.gamma[:n], b.gamma[:n], rtol=1e-3)


def test_packed_codes_and_logits_match(runs):
    jpacked = jpack(runs["jcfg"], runs["jq"])
    theirs = dict(quantized_leaves(
        params_from_numpy(to_numpy(jpacked))["layers"]))
    ours = dict(quantized_leaves(tpack(runs["tcfg"], runs["tq"])["layers"]))
    assert list(ours) == list(theirs) and ours
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    assert diff / sum(qt.packed.numel() for qt in ours.values()) <= 1e-2
    last = runs["tc"][-1]
    lt = TT.forward(runs["tcfg"].model, tpack(runs["tcfg"], runs["tq"]),
                    last["tokens"], last.get("embeds"))
    lj, _ = JT.forward(runs["jcfg"].model, jpacked,
                       jnp.asarray(last["tokens"].numpy()),
                       runs["jc"][-1].get("embeds"))
    assert rel(lt.numpy(), lj) <= 1e-3


def test_generate_greedy_tokens_equal(runs):
    """On the JAX-packed weights; pixtral's requests carry 8 patch
    embeddings, so decode starts at position 8 + 8."""
    jpacked = jpack(runs["jcfg"], runs["jq"])
    tpacked = params_from_numpy(to_numpy(jpacked))
    prompt = JMarkovLM(128, seed=3).batch(2, 8)
    jb = {"tokens": jnp.asarray(prompt["tokens"])}
    tb = {"tokens": t(prompt["tokens"]).long()}
    e = _front(runs["tcfg"].model, 2, seed=30)
    if e is not None:
        jb["embeds"], tb["embeds"] = _both(e)
    jr = jengine.generate(runs["jcfg"], jpacked, jb, max_new_tokens=6)
    seen = []
    orig = tengine.DecodeLoop

    class Loop(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(int(self.pos[0]))

    tengine.DecodeLoop = Loop
    try:
        tr = tengine.generate(runs["tcfg"], tpacked, tb, device="cpu",
                              max_new_tokens=6)
    finally:
        tengine.DecodeLoop = orig
    assert seen == [8 + runs["tcfg"].model.frontend_tokens]
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# soft caps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("r,s,hd,kv_block", [(4, 200, 80, 80),
                                             (2, 75, 64, 32)])
def test_int8_kv_attention_softcap_matches_jax(softcap, r, s, hd, kv_block):
    """Scores large enough that the cap of 30 bends them (q scaled up)."""
    rng = np.random.RandomState(int(softcap) + s)
    args = list(kv_case(rng, 3, s, 2, r, hd, kv_block))
    args[0] = args[0] * 40.0
    got = tops.int8_kv_attention(*(t(a) for a in args), kv_block=kv_block,
                                 softcap=softcap).numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.int8_kv_attention(
        *jargs, kv_block=kv_block, softcap=softcap, impl="pallas"))
    oracle = np.asarray(jref.int8_kv_attention_ref(*jargs, kv_block,
                                                   softcap))
    tol = 1e-5 * np.max(np.abs(pallas))
    assert np.max(np.abs(got - pallas)) <= tol
    np.testing.assert_array_equal(got[-1], 0.0)
    assert np.max(np.abs(got[:-1] - oracle[:-1])) <= tol
    if softcap:                         # the cap moved the result
        plain = tops.int8_kv_attention(*(t(a) for a in args),
                                       kv_block=kv_block).numpy()
        assert np.max(np.abs(plain - got)) > 100 * tol


@pytest.mark.parametrize("kv_cache", ["bf16", "int8"])
def test_softcaps_through_the_model(kv_cache):
    caps = dict(attn_logits_softcap=30.0, logits_softcap=20.0)
    jcfg, tcfg, jparams, tparams = _setup("h2o-danube-1.8b", seed=2, **caps)
    jdt, tdt = (("int8", "int8") if kv_cache == "int8"
                else (jnp.bfloat16, torch.bfloat16))
    toks = np.asarray(JMarkovLM(128, seed=6).batch(2, 20)["tokens"])
    lj, _ = JT.forward(jcfg.model, jparams, jnp.asarray(toks))
    lt = TT.forward(tcfg.model, tparams, t(toks))
    assert rel(lt.numpy(), lj) <= 1e-5
    assert float(lt.abs().max()) <= 20.0
    want, _ = _ring_run(jcfg.model, jparams, toks, 24, jdt, JAX_RING)
    got, _ = _ring_run(tcfg.model, tparams, toks, 24, tdt, PORT_RING)
    tol = 1e-4 if kv_cache == "int8" else 1e-5
    for g, w in zip(got, want):
        assert rel(g, w) <= tol
    # without the caps the logits differ
    _, tnc, _, tpnc = _setup("h2o-danube-1.8b", seed=2)
    assert rel(TT.forward(tnc.model, tpnc, t(toks)).numpy(), lj) > 1e-3


def _w4a16_case(rng, m, k, n, g, dtype):
    w = torch.from_numpy(rng.randn(n, k).astype(np.float32)) * k ** -0.5
    qp = compute_qparams(w, 4, g)
    packed = pack_int4(quantize_codes(w, qp, 4, g))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dtype)
    return x, packed, qp.scales, qp.zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_pad_k_adds_exact_zeros(dtype):
    """minicpm smoke's k 72 padded to 96 for the kernel: zero columns,
    codes, scales and zeros; the plain version on the padded operands
    gives the unpadded result (fp32 sums of the same products plus exact
    zeros, ≤ 1e-6 of the largest output)."""
    x, packed, scales, zeros = _w4a16_case(np.random.RandomState(72), 5, 72,
                                           40, 8, dtype)
    xp, pp, sp, zp = tops.w4a16_pad_k(x, packed, scales, zeros, 8)
    assert (xp.shape, pp.shape, sp.shape, zp.shape) == (
        (5, 96), (40, 48), (40, 12), (40, 12))
    assert not xp[:, 72:].any() and not pp[:, 36:].any()
    assert not sp[:, 9:].any() and not zp[:, 9:].any()
    want = tref.w4a16_matmul(x, packed, scales, zeros, 8).float()
    got = tref.w4a16_matmul(xp, pp, sp, zp, 8).float()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    same = tops.w4a16_pad_k(xp, pp, sp, zp, 8)
    assert all(a is b for a, b in zip(same, (xp, pp, sp, zp)))


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention_ring_hd80(cuda, softcap, dtype):
    """h2o-danube's decode shape (KV 8, R 4, hd 80, one scale block of 80
    a row) on a 4096-slot ring just past its wrap (slot order no longer
    position order; the last lane empty), against the plain version at
    the pins of test_gpu_int8_kv_attention, bitwise repeatable; at
    softcap 0 bitwise the uncapped call."""
    rng = np.random.RandomState(80)
    s, blk = 4096, kv_codec.default_kv_block(80)
    assert blk == 80
    args = [t(a).to(cuda) for a in kv_case(rng, b=2, s=s, kv=8, r=4, hd=80,
                                           kv_block=blk)]
    # with the cap, scores it bends (as a capped model's are)
    args[0] = (args[0] * (40.0 if softcap else 1.0)).to(dtype)
    pos = torch.tensor([4100, 4096], device=cuda)
    args[5] = TA.cache_key_positions(pos, s, s).to(torch.int32)
    args[5][-1] = -1
    want = tref.int8_kv_attention(*args, blk, softcap).float()
    got = tops.int8_kv_attention_cuda(*args, blk, softcap)
    assert torch.equal(got, tops.int8_kv_attention_cuda(*args, blk,
                                                         softcap))
    if not softcap:
        assert torch.equal(got, tops.int8_kv_attention_cuda(*args, blk))
    got = got.float()
    assert float(got[-1].abs().max()) == 0.0
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_w4a16_matmul_k_72(cuda, m, dtype):
    """The dispatcher at minicpm smoke's k 72 (group 8), padded for the
    kernel, against the plain version at the pins of
    test_gpu_w4a16: 1e-5 of the largest output in fp32, one bf16
    ulp in bf16."""
    args = [a.to(cuda) for a in _w4a16_case(np.random.RandomState(m), m,
                                             72, 160, 8, dtype)]
    want = tref.w4a16_matmul(*args, 8).float()
    got = tops.w4a16_matmul(*args, group_size=8).float()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    else:
        diff = (got - want).abs().cpu().numpy()
        assert np.all(diff <= bf16_ulp(want.cpu().numpy()))

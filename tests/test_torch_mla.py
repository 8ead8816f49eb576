"""The port's multi-head latent attention and MTP head (deepseek-v3-671b)
against the JAX package's.

deepseek smoke (3 layers, the first dense and two routed-MoE layers;
d_model 64, 4 heads, MLA ranks q 32 / kv 16, nope 16 / rope 8 / v 16; 8
experts top 2 and one shared; one MTP depth; group and blocksize 8), every
case on the same numpy inputs from a seed, weights carried across by
``convert.params_from_numpy``. Pins:

- MLA (``mla_forward``, ``mla_prefill``, its chunked continuation
  ``start=`` over cached latents, ``mla_decode`` over the latent cache):
  ≤ 1e-5 relative in fp32, the latent caches too; the cache written in
  place at ``[start, start + S)`` and at ``pos``; the latent cache in bf16
  where ``serve.kv_cache=int8``, as the reference's ``_float_cache_dtype``;
- the model at fp32: ``forward`` and ``mtp_logits`` ≤ 1e-5; ``prefill``, 3
  decode steps and the chunked prefill ≤ 1e-3. The routed experts compute
  in bf16 at any model dtype, so an fp32 sum one rounding apart can round
  an expert input to the neighbouring bf16 value (the routed-MoE pin of
  tests/test_torch_moe.py); with the experts off the same paths hold 1e-5;
  ``tree_to_numpy`` ∘ ``params_from_numpy`` bit for bit;
- a whole ``quantize_model`` at model dtype float32 (JAX with
  ``quant.jit_capture=false``) on ``MarkovLM(vocab, seed=7)``, 3 × 4 × 32:
  record names (the 7 MLA linears ``q_down, q_up, kv_down, k_rope, k_up,
  v_up, o``) and modes equal; layer 1 (dense) and layer 2's MLA and
  shared-expert linears iterations equal and Γ ≤ 1e-3, their packed codes
  differing in ≤ 1e-2 of the bytes. Layer 2's routed experts carry a
  rounding tie (ROADMAP.md §3): 3 packed bytes of expert 7's ``w_gate``
  differ, so its experts hold the pins of one flip
  (iterations within 1, Γ ≤ 6e-2) and layer 3, which calibrates on what
  layer 2 gives, its records' names and modes and iterations within 1.
  Logits on the JAX-packed weights through both packages ≤ 1e-3, each
  package's own packed model ≤ 1e-1 (the MoE flip pin). ``pack_for_serving``
  RTN-packs ``mtp.layer.*`` (codes, scales and zeros equal to JAX's) and
  keeps ``mtp.proj`` float; ``mtp_logits`` on the packed weights ≤ 1e-3;
  greedy ``generate`` on the JAX-packed weights gives the JAX engine's
  tokens (log-probabilities within 1e-2 relative: the compiled engine's
  MoE rounding, ROADMAP.md §3); a continuous run (2 lanes, prefill chunk
  3, each chunk at its own expert capacity) gives the JAX
  ``ContinuousEngine``'s tokens; both launchers run ``--arch
  deepseek-v3-671b --smoke --device cpu``.

On the card (``gpu``): the replayed decode step bitwise the eager step.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

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
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving.scheduler import ContinuousEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.pipeline import quantize_model as tquantize
from repro_torch.core.quant import QuantizedTensor, quantized_leaves
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousEngine as TEngine

from test_torch_models import rel, to_numpy
from test_torch_rglru import replay_matches_eager

ARCH = "deepseek-v3-671b"
MLA_LINEARS = ("q_down", "q_up", "kv_down", "k_rope", "k_up", "v_up", "o")


def t(a):
    return torch.from_numpy(np.array(a))


def _setup(dtype="float32", seed=0, experts=None):
    jcfg, tcfg = jget_config(ARCH, smoke=True), tget_config(ARCH, smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = dtype
        if experts is not None:
            cfg.model.moe.num_experts = experts
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_numpy(to_numpy(jparams))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


def _pos(b, s, start=0):
    return np.tile(np.arange(start, start + s, dtype=np.int32), (b, 1))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg, _, _ = _setup()
    jp = JA.init_mla(jcfg.model, jax.random.PRNGKey(4))
    return jcfg, tcfg, jp, params_from_numpy({"m": to_numpy(jp)})["m"]


def test_mla_forward_matches_jax(mla):
    jcfg, tcfg, jp, tp = mla
    x = np.random.RandomState(1).randn(2, 11, 64).astype(np.float32)
    jy = JA.mla_forward(jcfg.model, jp, jnp.asarray(x),
                        jnp.asarray(_pos(2, 11)))
    ty = TA.mla_forward(tcfg.model, tp, t(x), t(_pos(2, 11)).long())
    assert rel(ty.numpy(), jy) <= 1e-5


def test_mla_prefill_continuation_and_decode_match_jax(mla):
    """A prefill of 6 positions, a continuation chunk of 5 at start 6
    (queries over the 6 cached latents and the chunk), then 3 decode
    steps over the whole latent cache of 16 slots."""
    jcfg, tcfg, jp, tp = mla
    mj, mt = jcfg.model, tcfg.model
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 64).astype(np.float32)
    jc = JA.init_mla_cache(mj, 2, 16, jnp.float32)
    tc = TA.init_mla_cache(mt, 2, 16, "cpu", torch.float32)
    ptrs = [v.data_ptr() for v in tc.values()]
    for start, s in ((None, 6), (6, 5)):
        off = start or 0
        xs = x[:, off:off + s]
        jy, jc = JA.mla_prefill(mj, jp, jnp.asarray(xs),
                                jnp.asarray(_pos(2, s, off)), jc,
                                start=start)
        ty, out = TA.mla_prefill(mt, tp, t(xs), t(_pos(2, s, off)).long(),
                                 tc, start=start)
        assert out is tc
        assert rel(ty.numpy(), jy) <= 1e-5, start
        for k in ("ckv", "krope"):
            assert rel(tc[k].numpy(), jc[k]) <= 1e-5, (start, k)
    # the continuation against one prefill of all 11 positions
    full = TA.init_mla_cache(mt, 2, 16, "cpu", torch.float32)
    ty_full, _ = TA.mla_prefill(mt, tp, t(x), t(_pos(2, 11)).long(), full)
    assert rel(ty.numpy(), ty_full[:, 6:].numpy()) <= 1e-5
    pos = np.array([11, 11], np.int32)
    for i in range(3):
        xs = rng.randn(2, 1, 64).astype(np.float32)
        jy, jc = JA.mla_decode(mj, jp, jnp.asarray(xs), jnp.asarray(pos), jc)
        ty, _ = TA.mla_decode(mt, tp, t(xs), t(pos).long(), tc)
        assert rel(ty.numpy(), jy) <= 1e-5, i
        for k in ("ckv", "krope"):
            assert rel(tc[k].numpy(), jc[k]) <= 1e-5, (i, k)
        pos = pos + 1
    assert ptrs == [v.data_ptr() for v in tc.values()]


def test_latent_cache_stays_float_under_int8():
    _, tcfg, _, _ = _setup()
    mc = tcfg.model
    spec = TT.layer_specs(mc)[0]
    assert spec == ("mla", "dense")
    for dtype, want in (("int8", torch.bfloat16),
                        (torch.float32, torch.float32)):
        cache = TT.init_layer_cache(mc, spec, 2, 12, "cpu", dtype)
        assert set(cache) == {"ckv", "krope"}
        assert cache["ckv"].shape == (2, 12, mc.mla.kv_lora_rank)
        assert cache["krope"].shape == (2, 12, mc.mla.qk_rope_head_dim)
        assert cache["ckv"].dtype == cache["krope"].dtype == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts", [8, 0], ids=["moe", "dense"])
def test_model_matches_jax(experts):
    """forward, mtp_logits, prefill + 3 decode steps and the chunked
    prefill (chunks of 5); with the experts off, at 1e-5 throughout."""
    jcfg, tcfg, jparams, tparams = _setup(experts=experts)
    tol = 1e-3 if experts else 1e-5
    mj, mt = jcfg.model, tcfg.model
    toks = np.random.RandomState(1).randint(0, 128, (2, 12)).astype(
        np.int32)
    jl, _, jh = JT.forward(mj, jparams, jnp.asarray(toks), unroll_eager=True,
                           return_hidden=True)
    tl, th = TT.forward_hidden(mt, tparams, t(toks).long())
    assert rel(tl.numpy(), jl) <= 1e-5
    jm = JT.mtp_logits(mj, jparams, jh, jnp.asarray(toks))
    tm = TT.mtp_logits(mt, tparams, th, t(toks).long())
    assert tm.shape == (2, 11, 128) and rel(tm.numpy(), jm) <= 1e-5
    jlg, jc = JT.prefill(mj, jparams, jnp.asarray(toks), 20,
                         cache_dtype=jnp.float32, unroll_eager=True)
    tlg, tc = TT.prefill(mt, tparams, t(toks).long(), 20,
                         cache_dtype=torch.float32)
    assert rel(tlg.numpy(), jlg) <= tol
    tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
    pos = np.full((2,), 12, np.int32)
    for i in range(3):
        jlg, jc = JT.decode_step(mj, jparams, jnp.asarray(tok),
                                 jnp.asarray(pos), jc, unroll_eager=True)
        tlg, tc = TT.decode_step(mt, tparams, t(tok).long(), t(pos).long(),
                                 tc)
        assert rel(tlg.numpy(), jlg) <= tol, i
        tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        pos = pos + 1
    jlg, _ = JT.prefill_chunked(mj, jparams, jnp.asarray(toks), 20, 5,
                                cache_dtype=jnp.float32, unroll_eager=True)
    tlg, _ = TT.prefill_chunked(mt, tparams, t(toks).long(), 20, 5,
                                cache_dtype=torch.float32)
    assert rel(tlg.numpy(), jlg) <= tol


def test_tree_layout_and_round_trip():
    _, tcfg, _, tparams = _setup()
    assert [s for s in TT.layer_specs(tcfg.model)] == [
        ("mla", "dense"), ("mla", "moe"), ("mla", "moe")]
    assert set(tparams["layers"][0]["mixer"]) == set(MLA_LINEARS)
    mtp = tparams["mtp"]
    assert set(mtp) == {"proj", "norm", "layer"}
    assert tuple(mtp["proj"]["w"].shape) == (128, 64)
    assert "w_gate" in mtp["layer"]["mlp"]
    back = dict(_flat(params_from_numpy(tree_to_numpy(tparams))))
    ours = dict(_flat(tparams))
    assert back.keys() == ours.keys()
    for k, v in ours.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# quantize → pack → generate, the continuous engine, the launchers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg, jparams, tparams = _setup()
    jcfg.quant.jit_capture = False
    jc = jcalib(JMarkovLM(128, seed=7), 3, 4, 32)
    tc = tcalib(TMarkovLM(128, seed=7), 3, 4, 32)
    jq, jrep = jquantize(jcfg, jparams, jc)
    tq, trep = tquantize(tcfg, tparams, tc, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jc=jc, tc=tc, jq=jq, jrep=jrep,
                tq=tq, trep=trep, jpacked=jpack(jcfg, jq),
                tpacked=tpack(tcfg, tq))


def _layers_of(records, n_layers=3):
    """The report's records split by layer (each layer's records start at
    its MLA ``mixer.k_rope``, the first of its sorted dense names)."""
    out, cur = [], []
    for r in records:
        if r.name == "mixer.k_rope" and cur:
            out.append(cur)
            cur = []
        cur.append(r)
    out.append(cur)
    assert len(out) == n_layers
    return out


def test_quantize_report_matches(runs):
    jl, tl = runs["jrep"].linears, runs["trep"].linears
    assert [(r.name, r.mode) for r in tl] == [(r.name, r.mode) for r in jl]
    assert all(r.mode != "skipped" for r in tl)
    tls, jls = _layers_of(tl), _layers_of(jl)
    assert {r.name for r in tls[0]} == {f"mixer.{n}" for n in MLA_LINEARS} \
        | {"mlp.gate", "mlp.up", "mlp.down"}
    for li, (ta, ja) in enumerate(zip(tls, jls)):
        for a, b in zip(ta, ja):
            routed = a.name.startswith("mlp.w_")
            if li == 0 or (li == 1 and not routed):
                assert (a.shape, a.iters) == (tuple(b.shape), b.iters), \
                    (li, a.name)
                tol = 1e-3
            else:
                assert abs(a.iters - b.iters) <= 1, (li, a.name)
                tol = 6e-2 if li == 1 else None
            n = min(len(a.gamma), len(b.gamma))
            if tol is not None:
                np.testing.assert_allclose(a.gamma[:n], b.gamma[:n],
                                           rtol=tol, err_msg=a.name)


def test_packed_codes_logits_and_mtp_match(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    theirs_tree = params_from_numpy(to_numpy(runs["jpacked"]))
    ours_tree = runs["tpacked"]
    theirs = dict(quantized_leaves(theirs_tree["layers"]))
    ours = dict(quantized_leaves(ours_tree["layers"]))
    assert list(ours) == list(theirs)
    held = {k: q for k, q in ours.items() if k.startswith("0.")
            or (k.startswith("1.") and ".w_" not in k)}
    assert len(held) == 10 + 10
    diff = sum(int((q.packed != theirs[k].packed).sum())
               for k, q in held.items())
    assert diff / sum(q.packed.numel() for q in held.values()) <= 1e-2
    # the MTP head: its layer RTN-packed on a fresh grid, equal to JAX's;
    # its projection float
    om = dict(quantized_leaves(ours_tree["mtp"]))
    tm = dict(quantized_leaves(theirs_tree["mtp"]))
    assert list(om) == list(tm) and len(om) == 13
    assert all(k.startswith("layer.") for k in om)
    for k, q in om.items():
        for f in ("packed", "scales", "zeros"):
            assert torch.equal(getattr(q, f), getattr(tm[k], f)), (k, f)
    assert not isinstance(ours_tree["mtp"]["proj"]["w"], QuantizedTensor)
    assert torch.equal(ours_tree["mtp"]["proj"]["w"],
                       theirs_tree["mtp"]["proj"]["w"])
    last = runs["tc"][-1]["tokens"]
    jlast = jnp.asarray(last.numpy())
    lj, _, hj = JT.forward(jcfg.model, runs["jpacked"], jlast,
                           unroll_eager=True, return_hidden=True)
    lt, ht = TT.forward_hidden(tcfg.model, theirs_tree, last)
    assert rel(lt.numpy(), lj) <= 1e-3
    mj = JT.mtp_logits(jcfg.model, runs["jpacked"], hj, jlast)
    mt = TT.mtp_logits(tcfg.model, theirs_tree, ht, last)
    assert rel(mt.numpy(), mj) <= 1e-3
    own = TT.forward(tcfg.model, ours_tree, last)
    assert rel(own.numpy(), lj) <= 1e-1


def test_generate_greedy_tokens_equal(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    tpacked = params_from_numpy(to_numpy(runs["jpacked"]))
    prompt = JMarkovLM(128, seed=3).batch(2, 8)["tokens"]
    jr = jengine.generate(jcfg, runs["jpacked"],
                          {"tokens": jnp.asarray(prompt)}, max_new_tokens=6)
    tr = tengine.generate(tcfg, tpacked, {"tokens": t(prompt).long()},
                          device="cpu", max_new_tokens=6)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-2, atol=1e-5)


def test_continuous_run_matches_jax(runs):
    """Three requests of 5, 9 and 7 tokens over 2 lanes, prefill chunks of
    3 over the latent cache, on the JAX-packed weights: tokens, steps and
    statuses equal."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    for cfg in (jcfg, tcfg):
        cfg.serve.max_batch, cfg.serve.prefill_chunk = 2, 3
    tpacked = params_from_numpy(to_numpy(runs["jpacked"]))
    data = np.random.RandomState(4)
    reqs = [(data.randint(0, 128, (1, n)), m)
            for n, m in ((5, 4), (9, 6), (7, 3))]
    out = []
    for eng in (JEngine(jcfg, runs["jpacked"], max_len=24),
                TEngine(tcfg, tpacked, max_len=24, device="cpu")):
        rids = [eng.submit({"tokens": p}, max_new_tokens=m)
                for p, m in reqs]
        done = eng.run()
        out.append([(list(map(int, done[r].tokens)), done[r].status)
                    for r in rids])
    assert out[0] == out[1]
    assert all(st == "ok" for _, st in out[1])


def test_launchers_run_deepseek_smoke(tmp_path):
    path, report = tlaunch_quantize.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--out",
         str(tmp_path / "q"), f"train.ckpt_dir={tmp_path / 'none'}",
         "quant.calib_batches=2", "quant.calib_batch_size=2",
         "quant.calib_seq_len=16"])
    assert {r.mode for r in report.linears} <= {"rpiq", "rtn-fallback"}
    assert len(report.linears) == 3 * 7 + 3 + 2 * (3 + 3 * 8)
    for argv in (["--params", path], ["--pack-rtn"]):
        res = tlaunch_serve.main(
            ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "8", "serve.max_new_tokens=4",
             "serve.kv_cache=int8"] + argv)
        assert tuple(res.tokens.shape) == (2, 4)


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
def test_gpu_replay_equals_the_eager_step(cuda):
    """deepseek smoke at its own bf16 and group size, quantized and packed
    on the card (k_rope at n 8): 12 replayed decode steps over the latent
    cache bitwise the eager steps."""
    cfg = tget_config(ARCH, smoke=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cuda")
    calib = tcalib(TMarkovLM(128, seed=7), 2, 2, 32)
    packed = tpack(cfg, tquantize(cfg, params, calib)[0])
    toks = TMarkovLM(128, seed=3).batch(2, 8)["tokens"].cuda()
    assert replay_matches_eager(cfg, packed, toks)

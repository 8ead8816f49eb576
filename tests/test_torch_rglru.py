"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package's.

recurrentgemma smoke (5 layers: rglru, rglru, local, rglru, rglru; d_model
64, 4 heads over 1 KV head, window 8, gated GELU MLP, tied embeddings,
logits soft-capped at 30; group and blocksize 8), every case on the same
numpy inputs from a seed, weights carried across by
``convert.params_from_numpy``. Pins:

- the recurrence: ``_chunked_recurrence`` against JAX's on S 2048 (two
  chunks of 1024, h carried across the boundary) and S 77, with and
  without h0: ≤ 1e-5 of the largest |h| in fp32 (the port's doubling scan
  and ``lax.associative_scan`` multiply in other orders);
- ``rglru_block`` (no state, and a state) and three ``rglru_decode``
  steps: y and the states ≤ 1e-5 relative in fp32; the block's state in
  the compute dtype, a decode step writing the state it was given in
  place, in that state's dtype;
- ``forward``, ``prefill`` + 15 decode steps (past the local layer's ring
  of 8 slots) and the chunked prefill: ≤ 1e-5 relative at model dtype
  float32, ≤ 2e-2 at bf16 (the frameworks round bf16 intermediates at
  other places); ``tree_to_numpy`` ∘ ``params_from_numpy`` bit for bit;
- a whole ``quantize_model`` at model dtype float32 (JAX with
  ``quant.jit_capture=false``) on ``MarkovLM(vocab, seed=7)``, 3 × 4 × 32:
  record names (``mixer.{in,gate,rg,ig,out}``, no ``mixer.conv``), modes
  and iterations equal, Γ ≤ 1e-3, packed codes differing in ≤ 1e-2 of the
  bytes (the conv taps not packed), packed logits ≤ 1e-3; greedy
  ``generate`` on the JAX-packed weights gives the JAX engine's tokens on
  the bf16 and the int8 ring; a continuous run (2 lanes, prefill chunk 3)
  gives the JAX ``ContinuousEngine``'s tokens; both launchers run
  ``--arch recurrentgemma-9b --smoke --device cpu``.

The pieces under the path: ``layers.gelu`` equal to ``jax.nn.gelu`` on
every bf16 input and within 1e-6 in fp32; the int8 decode attention at the
full-width local layers' shape (B 4, one kv-head of R 16 query rows, hd
256, ``kv_block`` 128, a 2048-slot ring past its wrap with invalid
slots): the plain version within 1e-5 of the largest output of the JAX
package's ``int8_kv_attention`` (its Pallas kernel in interpret mode, as
its own tests run it) and of its oracle ``int8_kv_attention_ref``.

On the card (``gpu``): the replayed decode step bitwise the eager step on
the bf16 and the int8 ring; ``int8_kv_attention`` at that shape (the R 16
instantiation) against its plain version, fp32 within 1e-5 of the largest
output and bf16 within one bf16 ulp, and at R 12 (rows padded to 16).
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving.scheduler import ContinuousEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.pipeline import quantize_model as tquantize
from repro_torch.core.quant import quantized_leaves
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousEngine as TEngine

from test_torch_kernels import bf16_ulp
from test_torch_models import rel, to_numpy

ARCH = "recurrentgemma-9b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def t(a):
    return torch.from_numpy(np.array(a))


def _setup(dtype="float32", seed=0):
    jcfg, tcfg = jget_config(ARCH, smoke=True), tget_config(ARCH, smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = dtype
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


# ---------------------------------------------------------------------------
# the recurrence and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2048, 77])
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_chunked_recurrence_matches_jax(s, with_h0):
    rng = np.random.RandomState(s)
    b, w = 2, 8
    a = rng.uniform(0.9, 0.999, (b, s, w)).astype(np.float32)
    bb = (rng.randn(b, s, w) * 0.1).astype(np.float32)
    h0 = (rng.randn(b, w) if with_h0 else np.zeros((b, w))).astype(
        np.float32)
    jh, jlast = JR._chunked_recurrence(jnp.asarray(a), jnp.asarray(bb),
                                       jnp.asarray(h0), chunk=1024)
    th, tlast = TR._chunked_recurrence(t(a), t(bb), t(h0), chunk=1024)
    jh, jlast = np.asarray(jh), np.asarray(jlast)
    tol = 1e-5 * np.abs(jh).max()
    assert np.abs(th.numpy() - jh).max() <= tol
    assert np.abs(tlast.numpy() - jlast).max() <= tol
    np.testing.assert_array_equal(tlast.numpy(), th[:, -1].numpy())


def test_gelu_is_jax_gelu():
    x = (np.random.RandomState(0).randn(4096) * 3).astype(np.float32)
    got = TL.gelu(t(x).bfloat16()).float().numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    np.testing.assert_array_equal(got, want)
    assert np.abs(TL.gelu(t(x)).numpy()
                  - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() <= 1e-6


def ring_kv_case(rng, b=4, s=2048, kv=1, r=16, hd=256, kv_block=128):
    """int8 KV-attention inputs (numpy) on a ring of s slots just past
    its wrap: lane i wrote position s + 37 * i last, so slot j holds the
    largest p <= that position with p % s == j; about a tenth of the slots
    invalid (-1), and the last lane empty."""
    nb = hd // kv_block
    q = (rng.randn(b, kv, r, hd) * hd ** -0.5).astype(np.float32)
    kc = rng.randint(-127, 128, size=(b, s, kv, hd)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(b, s, kv, hd)).astype(np.int8)
    ks = (rng.rand(b, s, kv, nb) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(b, s, kv, nb) * 0.02 + 1e-3).astype(np.float32)
    last = s + 37 * np.arange(b)[:, None]
    slot = np.arange(s)[None, :]
    kpos = (last - (last - slot) % s).astype(np.int32)
    kpos[rng.rand(b, s) < 0.1] = -1
    kpos[-1] = -1
    return q, kc, ks, vc, vs, kpos


def test_int8_kv_attention_at_r16_matches_jax():
    args = ring_kv_case(np.random.RandomState(16))
    got = tops.int8_kv_attention(*(t(a) for a in args), kv_block=128)
    assert got.shape == (4, 1, 16, 256)
    got = got.numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.int8_kv_attention(*jargs, kv_block=128,
                                               impl="pallas"))
    oracle = np.asarray(jref.int8_kv_attention_ref(*jargs, 128))
    tol = 1e-5 * np.max(np.abs(pallas))
    assert np.max(np.abs(got - pallas)) <= tol
    np.testing.assert_array_equal(got[-1], 0.0)
    assert np.max(np.abs(got[:-1] - oracle[:-1])) <= tol


def _block_params(jcfg):
    jp = JR.init_rglru_block(jcfg.model, jax.random.PRNGKey(3))
    return jp, params_from_numpy({"m": to_numpy(jp)})["m"]


def test_rglru_block_and_decode_match_jax():
    jcfg, tcfg, _, _ = _setup()
    jp, tp = _block_params(jcfg)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 64).astype(np.float32)
    jy, jst = JR.rglru_block(jcfg.model, jp, jnp.asarray(x))
    ty, tst = TR.rglru_block(tcfg.model, tp, t(x))
    assert rel(ty.numpy(), jy) <= 1e-5
    for k in ("conv", "h"):
        assert tst[k].dtype == torch.float32
        assert rel(tst[k].numpy(), jst[k]) <= 1e-5
    # a second block continuing from the state
    x2 = rng.randn(2, 5, 64).astype(np.float32)
    jy, jst = JR.rglru_block(jcfg.model, jp, jnp.asarray(x2), jst)
    ty, tst = TR.rglru_block(tcfg.model, tp, t(x2), tst)
    assert rel(ty.numpy(), jy) <= 1e-5
    assert rel(tst["h"].numpy(), jst["h"]) <= 1e-5
    # decode steps continuing from the block's state, written in place
    ptrs = {k: v.data_ptr() for k, v in tst.items()}
    for i in range(3):
        xs = rng.randn(2, 1, 64).astype(np.float32)
        jy, jst = JR.rglru_decode(jcfg.model, jp, jnp.asarray(xs), jst)
        ty, out = TR.rglru_decode(tcfg.model, tp, t(xs), tst)
        assert out is tst
        assert rel(ty.numpy(), jy) <= 1e-5, i
        for k in ("conv", "h"):
            assert tst[k].data_ptr() == ptrs[k]
            assert rel(tst[k].numpy(), jst[k]) <= 1e-5, (i, k)


def test_rglru_state_dtypes_follow_jax():
    """At bf16 compute: the zero state, the block's state and a decode
    step's state all bf16, as in the JAX package."""
    jcfg, tcfg, _, _ = _setup("bfloat16")
    jp, tp = _block_params(jcfg)
    x = np.random.RandomState(6).randn(2, 4, 64).astype(np.float32)
    st0 = TR.init_rglru_state(tcfg.model, 2, "cpu")
    jst0 = JR.init_rglru_state(jcfg.model, 2)
    _, tst = TR.rglru_block(tcfg.model, tp, t(x).bfloat16(), st0)
    _, jst = JR.rglru_block(jcfg.model, jp, jnp.asarray(x, jnp.bfloat16),
                            jst0)
    for k in ("conv", "h"):
        assert st0[k].shape == jst0[k].shape
        assert st0[k].dtype == tst[k].dtype == torch.bfloat16
        assert jst0[k].dtype == jst[k].dtype == jnp.bfloat16
    _, jst = JR.rglru_decode(jcfg.model, jp,
                             jnp.asarray(x[:, :1], jnp.bfloat16), jst)
    TR.rglru_decode(tcfg.model, tp, t(x[:, :1]).bfloat16(), tst)
    for k in ("conv", "h"):
        assert tst[k].dtype == torch.bfloat16 and jst[k].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype):
    jcfg, tcfg, jparams, tparams = _setup(dtype)
    mc = tcfg.model
    toks = np.random.RandomState(1).randint(0, 128, (2, 12)).astype(
        np.int32)
    jl, _ = JT.forward(jcfg.model, jparams, jnp.asarray(toks),
                       unroll_eager=True)
    assert rel(TT.forward(mc, tparams, t(toks).long()).float().numpy(),
               jl) <= TOL[dtype]
    # prefill past the local layer's window of 8, then 15 decode steps
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jlg, jc = JT.prefill(jcfg.model, jparams, jnp.asarray(toks), 32,
                         cache_dtype=cdt, unroll_eager=True)
    tlg, tc = TT.prefill(mc, tparams, t(toks).long(), 32, cache_dtype=tdt)
    assert rel(tlg.numpy(), jlg) <= TOL[dtype]
    tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
    pos = np.full((2,), 12, np.int32)
    for i in range(15):
        jlg, jc = JT.decode_step(jcfg.model, jparams, jnp.asarray(tok),
                                 jnp.asarray(pos), jc, unroll_eager=True)
        tlg, tc = TT.decode_step(mc, tparams, t(tok).long(),
                                 t(pos).long(), tc)
        assert rel(tlg.numpy(), jlg) <= TOL[dtype], i
        tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        pos = pos + 1


def test_chunked_prefill_matches_jax_and_single_shot():
    jcfg, tcfg, jparams, tparams = _setup()
    toks = np.random.RandomState(2).randint(0, 128, (2, 13)).astype(
        np.int32)
    jlg, _ = JT.prefill_chunked(jcfg.model, jparams, jnp.asarray(toks), 24,
                                5, cache_dtype=jnp.float32,
                                unroll_eager=True)
    tlg, tc = TT.prefill_chunked(tcfg.model, tparams, t(toks).long(), 24, 5,
                                 cache_dtype=torch.float32)
    assert rel(tlg.numpy(), jlg) <= 1e-5
    slg, sc = TT.prefill(tcfg.model, tparams, t(toks).long(), 24,
                         cache_dtype=torch.float32)
    assert rel(tlg.numpy(), slg.numpy()) <= 1e-5
    for (n, a), (_, b) in zip(_flat(tc), _flat(sc)):
        assert np.abs(a.numpy() - b.numpy()).max() <= \
            1e-5 * max(np.abs(b.numpy()).max(), 1.0), n


def test_tree_round_trip_is_bitwise():
    _, tcfg, _, tparams = _setup()
    kinds = [s[0] for s in TT.layer_specs(tcfg.model)]
    assert kinds == ["rglru", "rglru", "local", "rglru", "rglru"]
    assert set(tparams["layers"][0]["mixer"]) == {
        "in", "gate", "conv", "rg", "ig", "lambda", "out"}
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
                tq=tq, trep=trep, jpacked=jpack(jcfg, jq))


def test_quantize_report_matches(runs):
    jl, tl = runs["jrep"].linears, runs["trep"].linears
    assert [r.name for r in tl] == [r.name for r in jl]
    rglru = {"mixer.in", "mixer.gate", "mixer.rg", "mixer.ig", "mixer.out",
             "mlp.gate", "mlp.up", "mlp.down"}
    assert {r.name for r in tl} == rglru | {"mixer.q", "mixer.k", "mixer.v",
                                            "mixer.o"}
    assert len(tl) == 4 * 8 + 7 and all(r.mode != "skipped" for r in tl)
    for a, b in zip(tl, jl):
        assert (a.mode, a.shape, a.iters) == (b.mode, tuple(b.shape),
                                              b.iters), a.name
        n = min(len(a.gamma), len(b.gamma))
        np.testing.assert_allclose(a.gamma[:n], b.gamma[:n], rtol=1e-3)


def test_packed_codes_and_logits_match(runs):
    theirs = dict(quantized_leaves(
        params_from_numpy(to_numpy(runs["jpacked"]))["layers"]))
    tpacked = tpack(runs["tcfg"], runs["tq"])
    ours = dict(quantized_leaves(tpacked["layers"]))
    assert list(ours) == list(theirs) and len(ours) == 39
    assert not any("conv" in k for k in ours)
    assert isinstance(tpacked["layers"][0]["mixer"]["conv"]["w"],
                      torch.Tensor)
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    assert diff / sum(qt.packed.numel() for qt in ours.values()) <= 1e-2
    last = runs["tc"][-1]["tokens"]
    lt = TT.forward(runs["tcfg"].model, tpacked, last)
    lj, _ = JT.forward(runs["jcfg"].model, runs["jpacked"],
                       jnp.asarray(last.numpy()), unroll_eager=True)
    assert rel(lt.numpy(), lj) <= 1e-3


@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_generate_greedy_tokens_equal(runs, kv_cache):
    """On the JAX-packed weights; 8 prompt + 6 new tokens cross the local
    layer's ring of 8 slots."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    jcfg.serve.kv_cache = tcfg.serve.kv_cache = kv_cache
    tpacked = params_from_numpy(to_numpy(runs["jpacked"]))
    prompt = JMarkovLM(128, seed=3).batch(2, 8)["tokens"]
    jr = jengine.generate(jcfg, runs["jpacked"],
                          {"tokens": jnp.asarray(prompt)}, max_new_tokens=6)
    tr = tengine.generate(tcfg, tpacked, {"tokens": t(prompt).long()},
                          device="cpu", max_new_tokens=6)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-4, atol=1e-5)


def test_continuous_run_matches_jax(runs):
    """Three requests of 5, 9 and 7 tokens over 2 lanes, prefill chunks of
    3 (the RG-LRU state carried across chunks), on the JAX-packed
    weights: tokens, steps and statuses equal."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    for cfg in (jcfg, tcfg):
        cfg.serve.kv_cache = "fp16"
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


def test_launchers_run_recurrentgemma_smoke(tmp_path):
    path, report = tlaunch_quantize.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--out",
         str(tmp_path / "q"), f"train.ckpt_dir={tmp_path / 'none'}",
         "quant.calib_batches=2", "quant.calib_batch_size=2",
         "quant.calib_seq_len=16"])
    assert len(report.linears) == 4 * 8 + 7
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


def replay_matches_eager(cfg, packed, toks, n_steps=12):
    """The decode loop's replayed steps bitwise its eager steps on a fresh
    prefill of the same prompt."""
    s = toks.shape[1]
    max_len = s + n_steps + 2
    lg, caches = tengine.prefill(cfg, packed, {"tokens": toks}, max_len)
    tok = torch.argmax(lg, -1)
    pos = torch.full((toks.shape[0],), s, dtype=torch.long,
                     device=toks.device)
    eager = []
    for _ in range(n_steps):
        lg, caches = TT.decode_step(cfg.model, packed, tok, pos, caches)
        tok = torch.argmax(lg, -1)
        eager.append(lg.clone())
        pos = pos + 1
    lg, caches = tengine.prefill(cfg, packed, {"tokens": toks}, max_len)
    loop = tengine.DecodeLoop(cfg, packed, lg, caches, s, n_steps + 1, -1,
                              0.0, None)
    got = [loop.step().clone()]
    graph = loop.capture()
    for _ in range(n_steps - 1):
        graph.replay()
        got.append(loop.logits.clone())
    return all(torch.equal(a, b) for a, b in zip(got, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_gpu_replay_equals_the_eager_step(cuda, kv_cache):
    """recurrentgemma smoke at its own bf16 and group size, quantized and
    packed on the card; 12 steps from position 8 cross the ring of 8."""
    cfg = tget_config(ARCH, smoke=True)
    cfg.serve.kv_cache = kv_cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cuda")
    calib = tcalib(TMarkovLM(128, seed=7), 2, 2, 32)
    packed = tpack(cfg, tquantize(cfg, params, calib)[0])
    toks = TMarkovLM(128, seed=3).batch(2, 8)["tokens"].cuda()
    assert replay_matches_eager(cfg, packed, toks)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [16, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_int8_kv_attention_r16(cuda, r, dtype):
    q, *cache = (t(a).to(cuda) for a in ring_kv_case(
        np.random.RandomState(r), r=r))
    q = q.to(dtype)
    got = tops.int8_kv_attention_cuda(q, *cache, 128)
    want = tref.int8_kv_attention(q, *cache, 128)
    assert got.shape == want.shape == (4, 1, r, 256)
    assert torch.equal(got, tops.int8_kv_attention_cuda(q, *cache, 128))
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    else:
        assert np.all(np.abs(g - w) <= bf16_ulp(w))

"""The chunked prefill and the continuous engine against the JAX package.

Smoke configs at model dtype float32, the JAX package's initial weights
through ``convert.params_from_numpy``, seeded numpy prompts.

Chunked prefill (``prefill_chunked`` / ``encdec_prefill_chunked``)
against the JAX package's chunked prefill on the same tokens, per family:
opt-proxy (bf16 cache), internlm2 (int8), h2o-danube (an int8 and a bf16
ring of 8 slots, the second chunk straddling the wrap), falcon-mamba (the
state carried across chunks), whisper (enc-dec, int8 self-cache) and
olmoe (each chunk at its own expert capacity; held against the JAX
package's op-by-op run, which its compiled run rounds otherwise,
ROADMAP.md §3). Pins: logits ≤ 1e-5 relative (Frobenius), int8 codes
differing in ≤ 1e-3 of the cells, bf16 cells within one bf16 ulp, f32
scales and states within 1e-5 of the largest. Within the port: chunked
against single-shot on a float32 cache (logits and caches ≤ 1e-5, the
Mamba state bitwise), and ``serve.prefill_chunk`` leaves ``generate``'s
greedy tokens as they were. The slot API (``cache_slots_like`` /
``cache_slot_insert`` / ``cache_slot_evict``) bitwise the JAX package's on
internlm2's int8 cache, falcon-mamba's state and whisper's self and cross
caches.

``ContinuousEngine`` against the JAX package's ``ContinuousEngine``
(opt-proxy, 2 lanes, prefill chunk 3; one JAX engine's compiled steps
serve every case) on the same requests: greedy tokens, steps and
statuses equal for mixed prompt lengths and budgets with more requests
than lanes, with an eos, cancelled while parked and mid-prefill,
timeouts on a virtual clock, the queue bound, a ``serve.decode_step``
quarantine (only the poisoned lane evicted) and a ``serve.prefill_chunk``
fault (only its request dropped); whisper (enc-dec) likewise. Each
request's tokens are also the port's static ``generate``'s. Sampled runs
repeat under one seed. On olmoe smoke at 24 lanes, where expert capacity
binds, a NaN lane's routing moves the same other rows' decode logits in
both packages (ROADMAP.md §3).

``gpu`` (skip without a card): on internlm2 smoke packed on the card with
the int8 cache, the replayed tick bitwise the eager tick, each lane's
tick output bitwise unchanged when another lane's cache and token change
(row independence), and insert and poison written into the captured
buffers.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import faults as jfaults
from repro.data import MarkovLM as JMarkovLM
from repro.models import transformer as JT
from repro.serving.scheduler import ContinuousEngine as JEngine
from repro.serving.scheduler import QueueFullError as JQueueFull
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tfaults
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import ContinuousEngine as TEngine
from repro_torch.serving.scheduler import QueueFullError as TQueueFull

from test_torch_kernels import bf16_ulp
from test_torch_models import rel, to_numpy


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()
    yield
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()


def _pair(arch, kv_cache="fp16", **serve):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = "float32"
        cfg.serve.kv_cache = kv_cache
        for k, v in serve.items():
            setattr(cfg.serve, k, v)
    init = JT.init_encdec_params if jcfg.model.is_encoder_decoder \
        else JT.init_params
    jparams = init(jcfg.model, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(to_numpy(jparams))


def _assert_caches_match(got, want):
    """Per-layer caches (the port's) against JAX's unstacked to the same
    layout: the pins of the module docstring."""
    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from ((f"{k}.{n}", x, y) for n, x, y in
                            pairs(a[k], b[k]))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                yield from ((f"{i}.{n}", u, v) for n, u, v in pairs(x, y))
        else:
            yield "", a, b
    for name, t, w in pairs(got, want):
        if t.dtype == torch.int8:
            assert np.mean(t.numpy() != w.numpy()) <= 1e-3, name
        elif t.dtype == torch.bfloat16:
            wf = w.float().numpy()
            assert np.all(np.abs(t.float().numpy() - wf) <= bf16_ulp(wf)), \
                name
        else:
            wf = w.float().numpy()
            assert np.abs(t.float().numpy() - wf).max() <= \
                1e-5 * max(np.abs(wf).max(), 1.0), name


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

# arch, serve.kv_cache, prompt length, chunk (max_len 24; h2o-danube smoke's
# ring holds 8 slots, so its second chunk [5, 10) straddles the wrap)
CHUNKED = [("opt-proxy", "fp16", 9, 4), ("internlm2-1.8b", "int8", 9, 4),
           ("h2o-danube-1.8b", "int8", 13, 5),
           ("h2o-danube-1.8b", "fp16", 13, 5),
           ("falcon-mamba-7b", "fp16", 9, 4), ("olmoe-1b-7b", "int8", 8, 4)]


@pytest.mark.parametrize("arch,kv_cache,s,chunk", CHUNKED,
                         ids=[f"{a}-{k}" for a, k, _, _ in CHUNKED])
def test_chunked_prefill_matches_jax(arch, kv_cache, s, chunk):
    jcfg, tcfg, jparams, tparams = _pair(arch, kv_cache)
    toks = np.random.RandomState(0).randint(0, tcfg.model.vocab_size, (2, s))
    cdt = tengine.cache_dtype(tcfg)
    run = functools.partial(
        JT.prefill_chunked, jcfg.model, max_len=24, chunk=chunk,
        cache_dtype="int8" if kv_cache == "int8" else jnp.bfloat16)
    if tcfg.model.moe.num_experts:      # the op-by-op run
        lj, cj = run(jparams, jnp.asarray(toks), unroll_eager=True)
    else:
        lj, cj = jax.jit(run)(jparams, jnp.asarray(toks))
    lt, ct = TT.prefill_chunked(tcfg.model, tparams, torch.from_numpy(toks),
                                24, chunk, cache_dtype=cdt)
    assert rel(lt.numpy(), lj) <= 1e-5
    want = params_from_numpy({"blocks": to_numpy(cj)})["layers"]
    _assert_caches_match(ct, want)
    if tcfg.model.window_size:
        assert ct[0]["k"].shape[1] == tcfg.model.window_size < s


def test_encdec_chunked_prefill_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair("whisper-large-v3", "int8")
    rs = np.random.RandomState(1)
    frames = rs.standard_normal(
        (2, tcfg.model.encoder_seq_len, tcfg.model.d_model)).astype(
            np.float32)
    toks = rs.randint(0, tcfg.model.vocab_size, (2, 7))
    lj, cj = jax.jit(functools.partial(
        JT.encdec_prefill_chunked, jcfg.model, max_len=20, chunk=3,
        cache_dtype="int8"))(jparams, jnp.asarray(frames), jnp.asarray(toks))
    lt, ct = TT.encdec_prefill_chunked(tcfg.model, tparams,
                                       torch.from_numpy(frames),
                                       torch.from_numpy(toks), 20, 3,
                                       cache_dtype="int8")
    assert rel(lt.numpy(), lj) <= 1e-5
    want = params_from_numpy({"decoder": {"layers": to_numpy(cj)}})
    _assert_caches_match(ct, want["decoder"]["layers"])


@pytest.mark.parametrize("arch", ["opt-proxy", "falcon-mamba-7b"])
@pytest.mark.parametrize("chunk", [3, 4, 9])
def test_chunked_against_single_shot(arch, chunk):
    _, tcfg, _, tparams = _pair(arch)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.model.vocab_size, (3, 9)))
    l1, c1 = TT.prefill(tcfg.model, tparams, toks, 24, torch.float32)
    l2, c2 = TT.prefill_chunked(tcfg.model, tparams, toks, 24, chunk,
                                torch.float32)
    assert rel(l2.numpy(), l1.numpy()) <= 1e-5
    _assert_caches_match(c2, c1)
    if arch == "falcon-mamba-7b":
        for a, b in zip(c1, c2):
            assert torch.equal(a["h"], b["h"])


def test_prefill_chunk_leaves_generate_tokens():
    _, tcfg, _, tparams = _pair("opt-proxy")
    batch = {"tokens": torch.from_numpy(np.random.RandomState(3).randint(
        0, tcfg.model.vocab_size, (3, 8)))}
    ref = tengine.generate(tcfg, tparams, batch, device="cpu",
                           max_new_tokens=5)
    tcfg.serve.prefill_chunk = 3
    got = tengine.generate(tcfg, tparams, batch, device="cpu",
                           max_new_tokens=5)
    assert torch.equal(got.tokens, ref.tokens)


def _port_layout(jcfg, caches):
    """JAX caches (stacked layers) as the port's per-layer list."""
    if jcfg.model.is_encoder_decoder:
        return params_from_numpy(
            {"decoder": {"layers": to_numpy(caches)}})["decoder"]["layers"]
    return params_from_numpy({"blocks": to_numpy(caches)})["layers"]


@pytest.mark.parametrize("arch,kv_cache", [
    ("internlm2-1.8b", "int8"), ("falcon-mamba-7b", "fp16"),
    ("whisper-large-v3", "int8")])
def test_slot_api_matches_jax(arch, kv_cache):
    """A batch-1 cache of the prefill's structure (every leaf: int8 codes,
    scales and error accumulators, a Mamba state, cross K/V), seeded
    values, inserted into lane 2 of 3 zeroed lanes, then evicted: the
    port's slotted cache bitwise the JAX package's at each step."""
    jcfg, _, jparams, _ = _pair(arch, kv_cache)
    mc = jcfg.model
    cdt = "int8" if kv_cache == "int8" else jnp.bfloat16
    toks = jnp.zeros((1, 6), jnp.int32)
    if mc.is_encoder_decoder:
        frames = jnp.zeros((1, mc.encoder_seq_len, mc.d_model))
        shapes = jax.eval_shape(functools.partial(
            JT.encdec_prefill, mc, max_len=12, cache_dtype=cdt),
            jparams, frames, toks)[1]
    else:
        shapes = jax.eval_shape(functools.partial(
            JT.prefill, mc, max_len=12, cache_dtype=cdt), jparams, toks)[1]
    rs = np.random.RandomState(9)
    cj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randint(-127, 128, a.shape), a.dtype)
        if a.dtype == jnp.int8
        else jnp.asarray(rs.standard_normal(a.shape), a.dtype), shapes)
    slots_j = JT.cache_slots_like(cj, 3)
    inserted_j = JT.cache_slot_insert(slots_j, cj, 2)
    evicted_j = JT.cache_slot_evict(inserted_j, 2)
    def assert_bitwise(got, want):
        want = list(TT.cache_leaves(_port_layout(jcfg, want)))
        leaves = list(TT.cache_leaves(got))
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            assert a.dtype == b.dtype and torch.equal(a, b)

    # each step in place, on the same tensors
    slots = TT.cache_slots_like(_port_layout(jcfg, cj), 3)
    ptrs = [a.data_ptr() for a in TT.cache_leaves(slots)]
    assert_bitwise(slots, slots_j)
    assert_bitwise(TT.cache_slot_insert(slots, _port_layout(jcfg, cj), 2),
                   inserted_j)
    assert_bitwise(TT.cache_slot_evict(slots, 2), evicted_j)
    assert ptrs == [a.data_ptr() for a in TT.cache_leaves(slots)]


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

_JAX_STEPS = ("_jit_decode", "_jit_decode_guarded", "_jit_insert",
              "_jit_pf_begin", "_jit_pf_step", "_jit_pf_finish")


@pytest.fixture(scope="module")
def opt():
    """opt-proxy at 2 lanes, chunk 3; ``jax_engine`` builds a JAX engine
    that reuses one prototype's compiled steps."""
    jcfg, tcfg, jparams, tparams = _pair("opt-proxy", max_batch=2,
                                         prefill_chunk=3)
    proto = JEngine(jcfg, jparams, max_len=40)

    def jax_engine(clock=None):
        eng = JEngine(jcfg, jparams, max_len=40, clock=clock)
        for name in _JAX_STEPS:
            setattr(eng, name, getattr(proto, name))
        return eng

    def port_engine(clock=None):
        return TEngine(tcfg, tparams, max_len=40, clock=clock, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, tparams=tparams, jax=jax_engine,
                port=port_engine)


MIXED = [(5, 4), (9, 7), (7, 2), (11, 5), (4, 1)]


def _requests(vocab, shapes=MIXED, seed=1):
    data = JMarkovLM(vocab, seed=seed)
    return [(np.array(data.batch(1, n)["tokens"]), m) for n, m in shapes]


def _submit(eng, reqs, **kw):
    return [eng.submit({"tokens": t}, max_new_tokens=m, **kw)
            for t, m in reqs]


def _outcome(done, rids):
    return [(done[r].tokens.tolist(), done[r].steps, done[r].status)
            if r in done else None for r in rids]


def _both(opt, reqs, spec=None, **kw):
    """Both engines on ``reqs`` (``spec`` armed in both planes): their
    outcomes and stats."""
    out = []
    for make, mod in ((opt["jax"], jfaults), (opt["port"], tfaults)):
        eng = make()
        rids = _submit(eng, reqs, **kw)
        if spec is None:
            done = eng.run()
        else:
            with mod.inject(spec):
                done = eng.run()
        out.append((_outcome(done, rids), dict(eng.stats)))
    return out


def test_mixed_lengths_chunked_match_jax_and_static(opt):
    reqs = _requests(opt["tcfg"].model.vocab_size)
    (jo, js), (to, ts) = _both(opt, reqs)
    assert to == jo and ts == js
    for (toks, m), (got, steps, status) in zip(reqs, to):
        ref = tengine.generate(opt["tcfg"], opt["tparams"],
                               {"tokens": torch.from_numpy(toks)},
                               device="cpu", max_new_tokens=m)
        assert status == "ok" and steps == int(ref.steps[0])
        assert got == ref.tokens[0, :steps].tolist()


def test_eos_matches_jax(opt):
    reqs = _requests(opt["tcfg"].model.vocab_size, [(8, 8)] * 3, seed=0)
    (clean, _), _ = _both(opt, reqs)
    eos = clean[0][0][2]
    (jo, _), (to, _) = _both(opt, reqs, eos_id=eos)
    assert to == jo and to[0][1] == 2


def _tick_until(engines, cond, n=30):
    for _ in range(n):
        for eng in engines:
            eng.step()
        if all(cond(eng) for eng in engines):
            return
    pytest.fail("the state to cancel in was never reached")


@pytest.mark.parametrize("where", ["parked", "mid-prefill"])
def test_cancel_matches_jax(opt, where):
    engines = [opt["jax"](), opt["port"]()]
    reqs = _requests(opt["tcfg"].model.vocab_size, [(4, 9), (4, 9), (9, 6)],
                     seed=2)
    rids = [_submit(eng, reqs[:2]) for eng in engines]
    for eng in engines:
        eng.step()                      # both lanes prefilled and decoding
    for eng, r in zip(engines, rids):
        r += _submit(eng, reqs[2:])
    if where == "parked":
        _tick_until(engines, lambda e: len(e._ready) == 1)
    else:
        _tick_until(engines, lambda e: e._prefill is not None
                    and 0 < e._prefill.start < e._prefill.h.shape[1])
    out = []
    for eng, r in zip(engines, rids):
        c = eng.cancel(r[2])
        assert c.status == "cancelled" and eng.stats["cancelled"] == 1
        assert eng._prefill is None and not eng._ready
        done = eng.run()
        assert r[2] not in done and eng.idle
        out.append((c.steps, _outcome(done, r[:2])))
    assert out[0] == out[1]


def test_timeouts_on_a_virtual_clock_match_jax(opt):
    reqs = _requests(opt["tcfg"].model.vocab_size, [(6, 8)] * 3, seed=4)
    out = []
    for make in (opt["jax"], opt["port"]):
        now = [0.0]
        eng = make(clock=lambda: now[0])
        rids = _submit(eng, reqs[:2], timeout_s=5.0)
        rids += _submit(eng, reqs[2:], timeout_s=50.0)
        done = {}
        for tick in range(40):
            if eng.idle:
                break
            now[0] = 2.0 * tick
            done.update({f.rid: f for f in eng.step().finished})
        out.append((_outcome(done, rids), eng.stats["timeout_evictions"]))
    assert out[0] == out[1]
    statuses = [o[2] for o in out[1][0]]
    assert statuses == ["timeout", "timeout", "ok"]


def test_queue_bound_matches_jax(opt):
    reqs = _requests(opt["tcfg"].model.vocab_size, [(6, 3)] * 3, seed=5)
    out = []
    for make, full, cfg in ((opt["jax"], JQueueFull, opt["jcfg"]),
                            (opt["port"], TQueueFull, opt["tcfg"])):
        cfg.serve.max_queue = 2
        try:
            eng = make()
            rids = _submit(eng, reqs[:2])
            with pytest.raises(full):
                _submit(eng, reqs[2:])
        finally:
            cfg.serve.max_queue = 0
        out.append((_outcome(eng.run(), rids), eng.stats["rejections"]))
    assert out[0] == out[1] and out[1][1] == 1


@pytest.mark.parametrize("spec,status", [
    ("serve.decode_step@2", "quarantined"),
    ("serve.prefill_chunk@1", "error")])
def test_faults_drop_only_their_request_as_in_jax(opt, spec, status):
    reqs = _requests(opt["tcfg"].model.vocab_size, [(6, 6)] * 3, seed=6)
    (clean, _), _ = _both(opt, reqs)
    (jo, js), (to, ts) = _both(opt, reqs, spec)
    assert to == jo and ts == js
    hit = [i for i, o in enumerate(to) if o[2] != "ok"]
    assert len(hit) == 1 and to[hit[0]][2] == status
    for i, o in enumerate(to):
        if i not in hit:
            assert o == clean[i]


def test_encdec_continuous_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair("whisper-large-v3", max_batch=2,
                                         prefill_chunk=2)
    rs = np.random.RandomState(7)
    frames = rs.standard_normal(
        (3, tcfg.model.encoder_seq_len, tcfg.model.d_model)).astype(
            np.float32)
    toks = rs.randint(0, tcfg.model.vocab_size, (3, 6))
    out = []
    for eng in (JEngine(jcfg, jparams, max_len=24),
                TEngine(tcfg, tparams, max_len=24, device="cpu")):
        rids = [eng.submit({"frames": frames[i:i + 1],
                            "tokens": toks[i:i + 1]}, max_new_tokens=5)
                for i in range(3)]
        out.append(_outcome(eng.run(), rids))
    assert out[0] == out[1]
    ref = tengine.generate(tcfg, tparams,
                           {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks)},
                           device="cpu", max_new_tokens=5)
    assert [o[0] for o in out[1]] == ref.tokens.tolist()


def test_sampled_runs_repeat_under_one_seed(opt):
    reqs = _requests(opt["tcfg"].model.vocab_size, [(6, 8)] * 2, seed=8)
    opt["tcfg"].serve.temperature = 1.0
    try:
        runs = []
        for seed in (3, 3, 4):
            eng = TEngine(opt["tcfg"], opt["tparams"], max_len=40, seed=seed,
                          device="cpu")
            rids = _submit(eng, reqs)
            runs.append(_outcome(eng.run(), rids))
    finally:
        opt["tcfg"].serve.temperature = 0.0
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_moe_nan_lane_reaches_the_rows_it_reaches_in_jax():
    """olmoe smoke (8 experts, top 2, capacity 8 rows) decoding 24 lanes:
    a lane of NaN routes to experts 0 and 1 in both packages and, first in
    the stable sort, takes their capacity ahead of the other rows, so the
    same other rows' logits move."""
    jcfg, tcfg, jparams, tparams = _pair("olmoe-1b-7b")
    b = 24
    toks = np.random.RandomState(0).randint(0, tcfg.model.vocab_size, (b, 6))
    lj, cj = jax.jit(functools.partial(JT.prefill, jcfg.model, max_len=12,
                                       cache_dtype="int8"))(
        jparams, jnp.asarray(toks))
    _, ct = TT.prefill(tcfg.model, tparams, torch.from_numpy(toks), 12,
                       "int8")
    tok, pos = np.argmax(np.asarray(lj), -1), np.full((b,), 6)
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg.model))

    def jstep(caches):
        return np.asarray(jdecode(jparams, jnp.asarray(tok),
                                  jnp.asarray(pos, jnp.int32), caches)[0])

    def tstep(caches):
        return TT.decode_step(tcfg.model, tparams, torch.from_numpy(tok),
                              torch.from_numpy(pos),
                              copy.deepcopy(caches))[0].numpy()

    jbad = jax.tree_util.tree_map(
        lambda a: a.at[:, 0].set(jnp.nan)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, cj)
    tbad = copy.deepcopy(ct)
    for layer in tbad:
        for v in layer.values():
            if v.is_floating_point():
                v[0] = float("nan")
    moved = []
    for clean, bad in ((jstep(cj), jstep(jbad)), (tstep(ct), tstep(tbad))):
        assert not np.isfinite(bad[0]).any()
        moved.append([i for i in range(1, b)
                      if not np.array_equal(clean[i], bad[i])])
    assert moved[0] == moved[1]


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(lanes=4):
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    cfg = tget_config("internlm2-1.8b", smoke=True)
    cfg.serve.kv_cache = "int8"
    cfg.serve.max_batch = lanes
    cfg.serve.prefill_chunk = 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cuda")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7), 2,
                                2, 32)
    packed = pack_for_serving(cfg, quantize_model(cfg, params, calib)[0])
    eng = TEngine(cfg, packed, max_len=48)
    data = MarkovLM(cfg.model.vocab_size, seed=3)
    for n in (5, 9, 7, 11)[:lanes]:
        eng.submit(data.batch(1, n), max_new_tokens=20)
    return eng


def _leaves(caches):
    return list(TT.cache_leaves(caches))


def _until_replaying(eng):
    """Tick until every lane is busy and the tick replays its graph."""
    while eng.active < eng.lanes or eng._graph is None:
        eng.step()


@pytest.mark.gpu
def test_gpu_replayed_tick_is_bitwise_the_eager_tick(cuda):
    eng = _card_engine()
    _until_replaying(eng)
    before = [a.clone() for a in _leaves(eng._caches)]
    eng._graph.replay()
    replayed = [t.clone() for t in eng._graph.out]
    after_replay = [a.clone() for a in _leaves(eng._caches)]
    for dst, src in zip(_leaves(eng._caches), before):
        dst.copy_(src)
    eager = eng._guarded_step()
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(eng._caches), after_replay))


@pytest.mark.gpu
def test_gpu_tick_rows_are_independent(cuda):
    eng = _card_engine()
    _until_replaying(eng)
    base = [a.clone() for a in _leaves(eng._caches)]
    tok = torch.from_numpy(eng._token).cuda()

    def replay_with(lane0_from, tok0):
        for dst, src in zip(_leaves(eng._caches), base):
            dst.copy_(src)
            dst[0].copy_(src[lane0_from])
        eng._tok_dev.copy_(tok)
        eng._tok_dev[0] = tok0
        eng._graph.replay()
        return [t.clone() for t in eng._graph.out]

    want = replay_with(0, int(tok[0]))
    # lane 0 takes lane 1's history and another token: every other lane's
    # tick output is unchanged, bit for bit
    got = replay_with(1, (int(tok[0]) + 1) % eng.cfg.model.vocab_size)
    for a, b in zip(got, want):
        assert torch.equal(a[1:], b[1:])


@pytest.mark.gpu
def test_gpu_insert_and_poison_write_the_captured_buffers(cuda):
    outs = []
    for spec in (None, "serve.decode_step@6"):
        eng = _card_engine(lanes=2)
        ptrs, done = None, {}
        with tfaults.inject(*([spec] if spec else [])):
            while not eng.idle:
                done.update({f.rid: f for f in eng.step().finished})
                if eng._graph is not None and ptrs is None:
                    ptrs = [a.data_ptr() for a in _leaves(eng._caches)]
        assert ptrs == [a.data_ptr() for a in _leaves(eng._caches)]
        outs.append(done)
    clean, hit = outs
    bad = [r for r, f in hit.items() if f.status == "quarantined"]
    assert len(bad) == 1 and len(hit) == 2
    for r, f in hit.items():
        if r not in bad:
            assert f.status == "ok"
            assert f.tokens.tolist() == clean[r].tokens.tolist()

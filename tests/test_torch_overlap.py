"""The port's overlap schedule of the layer walk against its serial
schedule and against the JAX package's overlap schedule.

Each architecture at smoke size, model dtype float32, the JAX package's
initial weights through ``convert.params_from_numpy``, calibration
``MarkovLM(vocab, seed=7)`` 2 × 2 × 16 (whisper: seeded numpy frames),
``test_torch_faults.py``'s small fixture:

- ``quant.pipeline=overlap`` is bitwise ``serial`` in the port: on-grid
  trees, packed artifacts and report records (name, shape, mode, stage-1
  error, Γ history, iterations) for opt-proxy, whisper-large-v3 (the
  enc→dec fence), olmoe-1b-7b (the MoE flip repair), falcon-mamba-7b,
  deepseek-v3-671b (MLA and routed experts) and recurrentgemma-9b;
- ``report.pipeline_stats`` has the JAX package's keys, and its
  structural counters (steps, speculative captures, repairs, the serial
  fallbacks by reason) equal the JAX package's overlap run, JAX with its
  default ``quant.jit_capture=true`` (false blocks its speculation). The
  MoE flip repair's ledger equals JAX's layer by layer on olmoe. On
  deepseek it does on the first routed layer (layer 2); layer 3 routes
  the stream layer 2 gives, and JAX's compiled capture forward rounds the
  bf16 expert products otherwise than its op-by-op layers (ROADMAP.md
  §3), which the port follows: its capacity drops there equal those of
  JAX's op-by-op run, and its flipped assignments lie within 2 of JAX's
  (16 against 17 of 128 seen);
- the dispatch's placement against a brute-force oracle and the JAX
  package's ``flipped_assignments`` (``tests/test_moe_flip.py``'s
  scenarios, fixed seeds; the port has no twin of that function, which
  only tests call); ``moe.reuse_plan`` where nothing flipped bitwise the
  plan made anew and JAX's;
- the fallback reasons: ``quant.moe_flip_budget=-1`` re-plans every MoE
  layer, ``_layer_repair_sound`` monkeypatched to False degrades every
  step, ``quant.jit_capture=false`` blocks speculation (each with the JAX
  package's counters and bitwise serial), an unknown mode raises
  ``ValueError`` in both packages;
- kill and resume under overlap, the twin of ``tests/test_faults.py``'s:
  ``plan.stage1_executor`` kills on opt-proxy, whisper (past the fence)
  and olmoe resume bitwise the uninterrupted run, and a
  ``stream.capture_forward@N`` schedule (a speculative capture fires the
  site too) kills at the same step in both packages;
- the two resume repairs: the fingerprint ignores ``faults.*`` as JAX's
  does; a launcher run killed under ``faults.arm=…`` resumes without it
  to the uninterrupted sha256; a resumed walk whose steps before the kill
  tripped the guardrail ladder reports JAX's ``guardrail_stats``.

On the card (``gpu``): overlap bitwise serial on opt-proxy and olmoe
smoke, and the speculative ``hessian_accum`` launches on a second stream.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import contextlib
import dataclasses
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.configs import get_config as jget_config
from repro.core import faults as jfaults
from repro.core import pipeline as jpipe
from repro.core import stream as jstream
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.distributed.checkpoint import Checkpointer as JCheckpointer
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tfaults
from repro_torch.core import pipeline as tpipe
from repro_torch.core import stream as tstream
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.distributed.checkpoint import Checkpointer as TCheckpointer
from repro_torch.kernels import ops
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.models import moe as tmoe

from test_torch_models import to_numpy

CALIB = (2, 2, 16)
ARCHS = ("opt-proxy", "whisper-large-v3", "olmoe-1b-7b", "falcon-mamba-7b",
         "deepseek-v3-671b", "recurrentgemma-9b")
STRUCTURAL = ("steps", "spec_captures", "repairs", "serial_fallbacks",
              "fallback_fence", "fallback_cross_slot",
              "fallback_eager_capture", "fallback_repair_unsound",
              "fallback_flip_budget")
LEDGER = ("moe_spec_layers", "moe_plan_reuses", "moe_flip_repairs",
          "moe_flipped_assignments", "moe_assignments", "moe_dropped_tokens")


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both planes disarmed."""
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()
    yield
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()


def _setup(arch):
    """Both packages' configs (float32), the JAX initial weights and the
    port's copy, and each package's calibration batches."""
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    mc = jcfg.model
    init = JT.init_encdec_params if mc.is_encoder_decoder else JT.init_params
    jparams = init(mc, jax.random.PRNGKey(0))
    jc = jcalib(JMarkovLM(mc.vocab_size, seed=7), *CALIB)
    tc = tcalib(TMarkovLM(mc.vocab_size, seed=7), *CALIB)
    if mc.is_encoder_decoder:
        for i, (a, b) in enumerate(zip(jc, tc)):
            fr = np.random.RandomState(20 + i).randn(
                CALIB[1], mc.encoder_seq_len, mc.d_model).astype(np.float32)
            a["frames"], b["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_numpy(to_numpy(jparams)), jc=jc, tc=tc)


def _with(cfg, **quant):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant,
                                                              **quant))


def _tquantize(s, **quant):
    cfg = _with(s["tcfg"], **quant)
    q, rep = tpipe.quantize_model(cfg, s["tparams"], s["tc"], device="cpu")
    return q, rep, tpipe.pack_for_serving(cfg, q)


@contextlib.contextmanager
def _ledger_by_layer(mod, out: list):
    """Record each ``_moe_members`` call's change to the walk's counters
    (one dict a routed layer) while the block runs."""
    real = mod._moe_members

    def wrapper(*args, **kwargs):
        st = kwargs.get("stats")
        before = dict(st) if st is not None else {}
        res = real(*args, **kwargs)
        if st is not None:
            out.append({k: st[k] - before[k] for k in LEDGER})
        return res

    mod._moe_members = wrapper
    try:
        yield
    finally:
        mod._moe_members = real


_RUNS = {}


def _runs(arch):
    """The port's serial and overlap runs and JAX's overlap run of
    ``arch``, once a module; the MoE ledger recorded layer by layer."""
    if arch not in _RUNS:
        s = _setup(arch)
        jled, tled = [], []
        with _ledger_by_layer(jpipe, jled):
            _, jrep = jpipe.quantize_model(_with(s["jcfg"],
                                                 pipeline="overlap"),
                                           s["jparams"], s["jc"])
        serial = _tquantize(s, pipeline="serial")
        with _ledger_by_layer(tpipe, tled):
            overlap = _tquantize(s, pipeline="overlap")
        _RUNS[arch] = dict(s, jrep=jrep, jled=jled, tled=tled, serial=serial,
                           overlap=overlap)
    return _RUNS[arch]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "packed"):
        return [tree.packed, tree.scales, tree.zeros]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _assert_bitwise(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0, what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


def _records(rep):
    return [(r.name, r.shape, r.mode, r.gptq_err, r.gamma, r.gamma_final,
             r.iters) for r in rep.linears]


def _assert_same_run(got, want, what):
    (qg, rg, pg), (qw, rw, pw) = got, want
    _assert_bitwise(qg, qw, f"{what}: on-grid tree")
    _assert_bitwise(pg, pw, f"{what}: packed artifact")
    assert _records(rg) == _records(rw), what
    assert rg.moe_capacity_dropped == rw.moe_capacity_dropped, what
    assert rg.guardrail_stats == rw.guardrail_stats, what


# ---------------------------------------------------------------------------
# overlap against serial, and against JAX's overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_overlap_is_bitwise_serial(arch):
    r = _runs(arch)
    _assert_same_run(r["overlap"], r["serial"], arch)
    st_o, st_s = r["overlap"][1].pipeline_stats, r["serial"][1].pipeline_stats
    assert st_o["mode"] == "overlap" and st_s["mode"] == "serial"
    assert st_o["steps"] == st_s["steps"] == \
        len(r["overlap"][1].layer_step_seconds)
    assert st_o["spec_captures"] > 0
    assert st_s["spec_captures"] == st_s["serial_fallbacks"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_structural_counters_match_jax(arch):
    r = _runs(arch)
    js, ts = r["jrep"].pipeline_stats, r["overlap"][1].pipeline_stats
    assert set(ts) == set(js)
    assert {k: ts[k] for k in STRUCTURAL} == {k: js[k] for k in STRUCTURAL}
    assert ts["repairs"] == ts["spec_captures"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_ledger_matches_jax(arch):
    """Layer by layer (module docstring: deepseek's layer 3 within the
    reach of JAX's compiled capture forward)."""
    r = _runs(arch)
    jled, tled = r["jled"], r["tled"]
    assert len(tled) == len(jled) > 0
    ts, js = r["overlap"][1].pipeline_stats, r["jrep"].pipeline_stats
    assert ts["moe_spec_layers"] == js["moe_spec_layers"] > 0
    assert ts["moe_assignments"] == js["moe_assignments"]
    assert sum(t["moe_flipped_assignments"] for t in tled) \
        == ts["moe_flipped_assignments"] > 0
    if arch == "olmoe-1b-7b":
        assert tled == jled
        assert {k: ts[k] for k in LEDGER} == {k: js[k] for k in LEDGER}
        return
    assert tled[0] == jled[0]
    last_t, last_j = tled[-1], jled[-1]
    assert last_t["moe_assignments"] == last_j["moe_assignments"]
    assert abs(last_t["moe_flipped_assignments"]
               - last_j["moe_flipped_assignments"]) <= 2
    _, jrep_eager = jpipe.quantize_model(_with(r["jcfg"], jit_capture=False),
                                         r["jparams"], r["jc"])
    assert r["overlap"][1].moe_capacity_dropped == \
        jrep_eager.moe_capacity_dropped
    assert ts["moe_dropped_tokens"] == \
        jrep_eager.pipeline_stats["moe_dropped_tokens"]


# ---------------------------------------------------------------------------
# the MoE flip repair's two functions
# ---------------------------------------------------------------------------

def _mcfg(e, k):
    return types.SimpleNamespace(moe=JMoEConfig(num_experts=e, top_k=k,
                                                capacity_factor=1.25))


def _experts(rng, scenario, t, k, e):
    if scenario == "overflow":
        # most assignments on two experts: segments overflow capacity
        pool = rng.choice([0, 1], size=(t, k)).astype(np.int64)
        return np.where(rng.random((t, k)) < 0.2,
                        rng.integers(0, e, (t, k)), pool)
    if scenario == "starved":
        return rng.integers(0, max(1, e // 2), (t, k))
    return rng.integers(0, e, (t, k))


def _heads(experts, seed):
    """The same routing head in both packages: ids and seeded gates."""
    g = np.random.RandomState(seed).uniform(size=experts.shape).astype(
        np.float32)
    g /= g.sum(-1, keepdims=True)
    return (jmoe.RouteHead(jnp.asarray(experts, jnp.int32), jnp.asarray(g),
                           jnp.float32(0.0)),
            tmoe.RouteHead(torch.from_numpy(experts.astype(np.int64)),
                           torch.from_numpy(g), torch.tensor(0.0)))


def _oracle_slots(experts, e, cap):
    """Each flat assignment's buffer row by direct simulation: the stable
    sort order, positions first come first served, the overflow to the
    drop row E·cap."""
    flat = experts.reshape(-1)
    slot = np.empty(flat.size, np.int64)
    handed = np.zeros(e, np.int64)
    for i in np.argsort(flat, kind="stable"):
        ex = int(flat[i])
        slot[i] = ex * cap + handed[ex] if handed[ex] < cap else e * cap
        handed[ex] += 1
    return slot


def _flat_slots(plan):
    """Each flat assignment's buffer row in a port plan (slot[i] belongs
    to sorted position i, flat index order[i])."""
    out = torch.zeros_like(plan.slot)
    out[plan.order] = plan.slot
    return out.numpy()


@pytest.mark.parametrize("scenario", ["sparse", "overflow", "starved"])
@pytest.mark.parametrize("seed", range(4))
def test_flipped_assignments_match_jax_and_oracle(scenario, seed):
    """The port's dispatch places every assignment where the brute-force
    oracle does; the placements two plans disagree on (a changed id, or a
    slot moved by a flip elsewhere in its segment) are JAX's
    ``flipped_assignments``; with no changed id nothing moves, which is
    what lets the flip repair decide on ids alone."""
    rng = np.random.default_rng(seed)
    t, k, e = 16, 2, 8
    cfg = _mcfg(e, k)
    cap = tmoe._capacity(cfg, t)
    true_e = _experts(rng, scenario, t, k, e)
    spec_e = true_e.copy()
    n_flip = int(rng.integers(1, t * k // 2 + 1))
    idx = rng.choice(t * k, size=n_flip, replace=False)
    spec_e.reshape(-1)[idx] = rng.integers(0, e, n_flip)
    (js, ts), (jt, tt) = _heads(spec_e, seed), _heads(true_e, seed + 1)
    spec_slots = _flat_slots(tmoe.plan_from_head(cfg, ts))
    true_slots = _flat_slots(tmoe.plan_from_head(cfg, tt))
    np.testing.assert_array_equal(spec_slots, _oracle_slots(spec_e, e, cap))
    np.testing.assert_array_equal(true_slots, _oracle_slots(true_e, e, cap))
    got = (spec_e.reshape(-1) != true_e.reshape(-1)) \
        | (spec_slots != true_slots)
    np.testing.assert_array_equal(got, np.asarray(jmoe.flipped_assignments(
        jmoe.plan_from_head(cfg, js), jmoe.plan_from_head(cfg, jt))))
    (_, again) = _heads(true_e, seed + 2)
    np.testing.assert_array_equal(
        _flat_slots(tmoe.plan_from_head(cfg, again)), true_slots)


@pytest.mark.parametrize("scenario", ["sparse", "overflow", "starved"])
@pytest.mark.parametrize("seed", range(2))
def test_reuse_plan_is_the_plan_made_anew(scenario, seed):
    """No flipped id: the speculative structure rebound to a head with
    fresh gates is bitwise the plan made from that head, field by field,
    and JAX's ``reuse_plan``'s."""
    rng = np.random.default_rng(100 + seed)
    t, k, e = 16, 2, 8
    cfg = _mcfg(e, k)
    experts = _experts(rng, scenario, t, k, e)
    (js, ts), (jt, tt) = _heads(experts, seed), _heads(experts, seed + 1)
    reused = tmoe.reuse_plan(tmoe.plan_from_head(cfg, ts), tt)
    direct = tmoe.plan_from_head(cfg, tt)
    jreused = jmoe.reuse_plan(jmoe.plan_from_head(cfg, js), jt)
    assert reused.cap == direct.cap == jreused.cap
    for f in ("experts", "gates", "aux", "order", "se", "st", "sg", "keep",
              "slot", "counts"):
        a, b = getattr(reused, f), getattr(direct, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jreused, f)),
                                      err_msg=f)
    xt = torch.from_numpy(np.random.RandomState(seed).randn(t, 4).astype(
        np.float32))
    assert torch.equal(tmoe.apply_route(reused, xt),
                       tmoe.apply_route(direct, xt))


# ---------------------------------------------------------------------------
# the fallback reasons
# ---------------------------------------------------------------------------

def _jax_overlap_stats(s, **quant):
    _, rep = jpipe.quantize_model(_with(s["jcfg"], pipeline="overlap",
                                        **quant), s["jparams"], s["jc"])
    return rep.pipeline_stats


def test_flip_budget_below_zero_replans_every_moe_layer():
    r = _runs("olmoe-1b-7b")
    got = _tquantize(r, pipeline="overlap", moe_flip_budget=-1.0)
    st = got[1].pipeline_stats
    assert st["fallback_flip_budget"] == st["moe_spec_layers"] > 0
    assert st["serial_fallbacks"] == st["fallback_flip_budget"]
    assert st["moe_plan_reuses"] == st["moe_flip_repairs"] == 0
    js = _jax_overlap_stats(r, moe_flip_budget=-1.0)
    assert {k: st[k] for k in STRUCTURAL + LEDGER} == \
        {k: js[k] for k in STRUCTURAL + LEDGER}
    _assert_same_run(got, r["serial"], "flip budget -1")


def test_unsound_repair_degrades_every_step(monkeypatch):
    r = _runs("opt-proxy")
    monkeypatch.setattr(tpipe, "_layer_repair_sound", lambda lp: False)
    monkeypatch.setattr(jpipe, "_layer_repair_sound", lambda lp: False)
    got = _tquantize(r, pipeline="overlap")
    st = got[1].pipeline_stats
    assert st["spec_captures"] == st["repairs"] == 0
    assert st["serial_fallbacks"] == st["fallback_repair_unsound"] \
        == st["steps"] - 1 > 0
    js = _jax_overlap_stats(r)
    assert {k: st[k] for k in STRUCTURAL} == {k: js[k] for k in STRUCTURAL}
    _assert_same_run(got, r["serial"], "repair unsound")


def test_jit_capture_false_blocks_speculation():
    r = _runs("opt-proxy")
    got = _tquantize(r, pipeline="overlap", jit_capture=False)
    st = got[1].pipeline_stats
    assert st["spec_captures"] == 0
    assert st["fallback_eager_capture"] == st["serial_fallbacks"] \
        == st["steps"] - 1 > 0
    js = _jax_overlap_stats(r, jit_capture=False)
    assert {k: st[k] for k in STRUCTURAL} == {k: js[k] for k in STRUCTURAL}
    _assert_same_run(got, r["serial"], "jit_capture=false")


def test_a_step_on_another_slot_is_not_captured_ahead():
    """Two layers on two stream slots: the second is not captured ahead
    (``fallback_cross_slot``), and both quantize as under serial."""
    s = _setup("opt-proxy")
    params = s["tparams"]

    def walker():
        w = tpipe._walker_decoder_only(s["tcfg"], params, s["tc"], "cpu")
        w.streams["h2"] = list(w.streams["h"])
        w.items[1].hs_slot = "h2"
        return w

    reps = {}
    for mode in ("serial", "overlap"):
        rep = tpipe.QuantReport()
        cfg = _with(s["tcfg"], pipeline=mode)
        q = tstream.run_walker(cfg, walker(), rep)
        reps[mode] = (q, rep, tpipe.pack_for_serving(cfg, q))
    st = reps["overlap"][1].pipeline_stats
    assert st["fallback_cross_slot"] == st["serial_fallbacks"] == 1
    assert st["spec_captures"] == 0
    _assert_same_run(reps["overlap"], reps["serial"], "cross slot")


def test_unknown_mode_raises_in_both():
    s = _setup("opt-proxy")
    with pytest.raises(ValueError, match="quant.pipeline"):
        tpipe.quantize_model(_with(s["tcfg"], pipeline="threaded"),
                             s["tparams"], s["tc"], device="cpu")
    with pytest.raises(ValueError, match="quant.pipeline"):
        jpipe.quantize_model(_with(s["jcfg"], pipeline="threaded"),
                             s["jparams"], s["jc"])


# ---------------------------------------------------------------------------
# kill and resume under overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,hit", [("opt-proxy", 5),
                                      ("whisper-large-v3", 8),
                                      ("olmoe-1b-7b", 4)])
def test_stage1_kill_then_resume_is_bitwise(arch, hit, tmp_path):
    r = _runs(arch)
    kw = dict(pipeline="overlap", ckpt_dir=str(tmp_path), resume="auto")
    with pytest.raises(tfaults.FaultError):
        with tfaults.inject(f"plan.stage1_executor@{hit}"):
            _tquantize(r, **kw)
    got = _tquantize(r, **kw)
    st = got[1].pipeline_stats
    assert st.get("resumed_at", 0) > 0
    _assert_same_run(got, r["serial"], f"{arch} resumed")


@pytest.mark.parametrize("arch,hit", [("opt-proxy", 2), ("opt-proxy", 3),
                                      ("olmoe-1b-7b", 2),
                                      ("whisper-large-v3", 4)])
def test_capture_kill_lands_where_jax_lands(arch, hit, tmp_path):
    """``stream.capture_forward@N`` under overlap kills at the same step in
    both packages (the speculative captures count as hits): the same
    latest checkpoint; the port's resume is bitwise."""
    r = _runs(arch)
    latest = {}
    for name, mod, run, ck in (
            ("jax", jfaults,
             lambda d: jpipe.quantize_model(
                 _with(r["jcfg"], pipeline="overlap", ckpt_dir=d,
                       resume="auto"), r["jparams"], r["jc"]),
             JCheckpointer),
            ("torch", tfaults,
             lambda d: _tquantize(r, pipeline="overlap", ckpt_dir=d,
                                  resume="auto"),
             TCheckpointer)):
        d = str(tmp_path / name)
        with pytest.raises(mod.FaultError) as e:
            with mod.inject(f"stream.capture_forward@{hit}"):
                run(d)
        assert e.value.hit == hit
        latest[name] = ck(d).latest_step()
    assert latest["torch"] == latest["jax"]
    got = _tquantize(r, pipeline="overlap", ckpt_dir=str(tmp_path / "torch"),
                     resume="auto")
    _assert_same_run(got, r["serial"], f"{arch} resumed")


# ---------------------------------------------------------------------------
# the resume repairs: the fingerprint, a launcher kill, guardrail_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,value,match", [
    ("faults.arm", "plan.stage1_executor@5", True),
    ("faults.seed", "3", True),
    ("quant.rpiq_iters", "6", False),
    ("quant.pipeline", "overlap", False)])
def test_fingerprint_ignores_faults_as_jax_does(key, value, match):
    from repro.config import apply_overrides as japply
    from repro_torch.config import apply_overrides as tapply
    got = {}
    for name, get, apply, fp in (
            ("jax", jget_config, japply, jstream._resume_fingerprint),
            ("torch", tget_config, tapply, tstream._resume_fingerprint)):
        a, b = get("opt-proxy", smoke=True), get("opt-proxy", smoke=True)
        apply(b, {key: value})
        got[name] = fp(a) == fp(b)
    assert got["torch"] == got["jax"] == match


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("pipeline", ["serial", "overlap"])
def test_launcher_kill_resumes_without_the_fault(pipeline, tmp_path):
    def launch(out, extra=()):
        return tlaunch_quantize.main(
            ["--arch", "opt-proxy", "--smoke", "--device", "cpu", "--out",
             str(tmp_path / out), f"train.ckpt_dir={tmp_path / 'none'}",
             "quant.calib_batches=2", "quant.calib_batch_size=2",
             "quant.calib_seq_len=16", f"quant.pipeline={pipeline}"]
            + list(extra))

    ref, _ = launch("ref")
    ck = [f"quant.ckpt_dir={tmp_path / 'ck'}", "quant.resume=auto"]
    with pytest.raises(tfaults.FaultError):
        launch("run", ck + ["faults.arm=plan.stage1_executor@5"])
    tfaults.PLANE.disarm()        # an armed launcher leaves the plane armed
    path, report = launch("run", ck)
    assert report.pipeline_stats.get("resumed_at", 0) > 0
    assert _sha(path) == _sha(ref)


@pytest.mark.parametrize("pipeline", ["serial", "overlap"])
def test_resumed_walk_reports_the_ladder_as_jax(pipeline, tmp_path):
    """``hessian.cholesky@1:nan`` trips the ladder in layer 1, the kill
    falls in layer 2; the resumed run reports the ladder's counts as JAX's
    resumed run does (JAX op by op, the ladder suite's setting)."""
    s = _setup("opt-proxy")
    armed = ("hessian.cholesky@1:nan", "plan.stage1_executor@5")
    got = {}
    for name, mod, run in (
            ("jax", jfaults,
             lambda **kw: jpipe.quantize_model(
                 _with(s["jcfg"], jit_capture=False, **kw), s["jparams"],
                 s["jc"])[1]),
            ("torch", tfaults, lambda **kw: _tquantize(s, **kw)[1])):
        kw = dict(pipeline=pipeline, ckpt_dir=str(tmp_path / name),
                  resume="auto")
        with pytest.raises(mod.FaultError):
            with mod.inject(*armed):
                run(**kw)
        rep = run(**kw)
        assert rep.pipeline_stats.get("resumed_at", 0) > 0
        got[name] = rep.guardrail_stats
    assert got["torch"] == got["jax"] == {
        "damp_retries": 2, "lanes_flagged": 1, "lanes_damp_recovered": 0,
        "lanes_rtn_forced": 1}


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
@pytest.mark.parametrize("arch", ["opt-proxy", "olmoe-1b-7b"])
def test_gpu_overlap_is_bitwise_serial_on_a_side_stream(cuda, arch,
                                                        monkeypatch):
    """Smoke at its own dtype and group size on the card: overlap bitwise
    serial, and ``hessian_accum`` launched on a second stream (the
    speculative captures)."""
    cfg = tget_config(arch, smoke=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    from repro_torch.models import transformer as TT
    params = TT.init_params(cfg.model, gen, "cuda")
    calib = tcalib(TMarkovLM(cfg.model.vocab_size, seed=7), 3, 4, 32)
    streams = {}
    real = ops.hessian_accum_cuda

    def counting(x, H):
        key = torch.cuda.current_stream().cuda_stream
        streams[key] = streams.get(key, 0) + 1
        return real(x, H)

    runs = {}
    for mode in ("serial", "overlap"):
        streams.clear()
        monkeypatch.setattr(ops, "hessian_accum_cuda", counting)
        c = _with(cfg, pipeline=mode)
        q, rep = tpipe.quantize_model(c, params, calib)
        runs[mode] = (q, rep, tpipe.pack_for_serving(c, q))
        runs[mode + "_streams"] = dict(streams)
    _assert_same_run(runs["overlap"], runs["serial"], arch)
    assert len(runs["serial_streams"]) == 1
    assert len(runs["overlap_streams"]) == 2
    assert runs["overlap"][1].pipeline_stats["spec_captures"] > 0

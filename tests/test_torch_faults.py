"""The port's fault plane and the stage-1 guardrail ladder against the JAX
package.

The plane (``repro_torch/core/faults.py``): every spec of the
``site@trigger[:mode]`` grammar parses to the JAX package's ``FaultSpec``
fields; fixed and open hit windows and the seeded probabilistic schedule
fire at the same hits in both packages (seeds 0-3, 40 hits); ``inject``
restores the previous arming, also when its fault propagates.

The ladder, on opt-proxy smoke in float32 (the JAX package's initial
weights through ``convert.params_from_numpy``, calibration ``MarkovLM
(vocab, seed=7)`` 2 × 2 × 16, JAX with ``quant.jit_capture=false``),
with ``hessian.cholesky@N:nonpsd`` and ``:nan`` armed in both packages:
``guardrail_stats`` equal, every record's name and mode equal (the
``"rtn-guardrail"`` lane among them), ``iters_run`` equal, and packed
codes differing in ≤ 1e-2 of the bytes (``tests/test_torch_pipeline.py``'s
opt-proxy pin), the guarded lane's codes, scales and zeros bitwise the
JAX package's (its RTN lane). The clean run shows no guardrail activity.
On a stacked toy group (3 lanes, the JAX suite's ``_toy_group`` shapes)
the lanes the fault did not touch come out bitwise the fault-free run's,
the rescued lane finite; with ``quant.guardrail=false`` the NaN lane
passes through. ``hessian.corrupt_stacked`` is held against the JAX
payload (``nan`` bitwise, ``nonpsd`` to 1e-6 of the lane's largest
entry) with the other lanes bitwise unchanged.

Kill and resume (the port alone, its own uninterrupted run the oracle):
``plan.stage1_executor``, ``plan.stage2_executor`` and
``stream.capture_forward`` kills under ``quant.resume=auto`` resume to
bitwise-equal artifacts; ``checkpoint.load:corrupt`` is caught (the
resume warns and starts afresh, to the same artifact) and on
``load_artifact`` raises the typed integrity error, another mode a
``FaultError``.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import faults as jfaults
from repro.core import hessian as jhess
from repro.core.pipeline import pack_for_serving as jpack
from repro.core.pipeline import quantize_model as jquantize
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tfaults
from repro_torch.core import hessian as thess
from repro_torch.core import plan as tplan
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.pipeline import quantize_model as tquantize
from repro_torch.core.quant import quantized_leaves
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.distributed import checkpoint as tckpt

from test_torch_models import to_numpy


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both planes disarmed."""
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()
    yield
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

SPECS = ["plan.stage1_executor@3", "serve.decode_step@2..5",
         "serve.engine_step@4+", "kernels.pallas_dispatch@p0.25",
         "hessian.cholesky@1:nonpsd", "checkpoint.load@2:corrupt",
         " serve.prefill_chunk@7:kill "]


@pytest.mark.parametrize("text", SPECS)
def test_spec_grammar_matches_jax(text):
    assert dataclasses.asdict(tfaults.parse_spec(text)) == \
        dataclasses.asdict(jfaults.parse_spec(text))


@pytest.mark.parametrize("text", ["serve.nowhere@1", "plan.stage1_executor",
                                  "hessian.cholesky@x"])
def test_bad_specs_are_refused_in_both(text):
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError):
            mod.parse_spec(text)


def _fired_hits(mod, spec, seed, n=40):
    hits = []
    with mod.inject(spec, seed=seed) as plane:
        for i in range(1, n + 1):
            if plane.poll("serve.decode_step") is not None:
                hits.append(i)
    return hits


@pytest.mark.parametrize("spec", ["serve.decode_step@3",
                                  "serve.decode_step@2..5",
                                  "serve.decode_step@4+",
                                  "serve.decode_step@p0.4"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedules_fire_at_the_same_hits(spec, seed):
    got = _fired_hits(tfaults, spec, seed)
    assert got == _fired_hits(jfaults, spec, seed)
    if "@p" not in spec:
        want = {"@3": [3], "@2..5": [2, 3, 4, 5],
                "@4+": list(range(4, 41))}[spec[spec.index("@"):]]
        assert got == want


def test_inject_restores_the_previous_arming():
    with tfaults.inject("plan.stage2_executor@1+"):
        with tfaults.inject("plan.stage2_executor@99"):
            tfaults.fire("plan.stage2_executor")     # hit 1 of @99
        with pytest.raises(tfaults.FaultError) as e:
            tfaults.fire("plan.stage2_executor")
        assert e.value.site == "plan.stage2_executor"
    assert not tfaults.armed("plan.stage2_executor")
    with pytest.raises(tfaults.FaultError):
        with tfaults.inject("plan.stage1_executor@1"):
            tfaults.fire("plan.stage1_executor")
    assert not tfaults.armed("plan.stage1_executor")
    tfaults.fire("plan.stage1_executor")              # unarmed: a no-op


# ---------------------------------------------------------------------------
# the guardrail ladder
# ---------------------------------------------------------------------------

CALIB = (2, 2, 16)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("opt-proxy", smoke=True)
    tcfg = tget_config("opt-proxy", smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    jcfg.quant.jit_capture = False
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    vocab = tcfg.model.vocab_size
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_numpy(to_numpy(jparams)),
                jc=jcalib(JMarkovLM(vocab, seed=7), *CALIB),
                tc=tcalib(TMarkovLM(vocab, seed=7), *CALIB))


_LADDER = {}


def _ladder_runs(model, spec):
    """Both packages' quantize → pack under ``spec`` (None: fault-free),
    once a module."""
    if spec not in _LADDER:
        out = []
        for mod, cfg, params, calib, quantize, pack in (
                (jfaults, model["jcfg"], model["jparams"], model["jc"],
                 jquantize, jpack),
                (tfaults, model["tcfg"], model["tparams"], model["tc"],
                 lambda c, p, b: tquantize(c, p, b, device="cpu"), tpack)):
            if spec is None:
                q, rep = quantize(cfg, params, calib)
            else:
                with mod.inject(spec):
                    q, rep = quantize(cfg, params, calib)
            out.append((rep, pack(cfg, q)))
        (jrep, jpk), (trep, tpk) = out
        _LADDER[spec] = (jrep, params_from_numpy(to_numpy(jpk)), trep, tpk)
    return _LADDER[spec]


@pytest.mark.parametrize("spec,rung", [
    (None, None),
    ("hessian.cholesky@1:nonpsd", "recovered"),
    ("hessian.cholesky@1:nan", "rtn")])
def test_ladder_matches_jax(model, spec, rung):
    jrep, jpk, trep, tpk = _ladder_runs(model, spec)
    assert trep.guardrail_stats == jrep.guardrail_stats
    assert [(r.name, r.mode, r.iters) for r in trep.linears] == \
        [(r.name, r.mode, r.iters) for r in jrep.linears]
    ours, theirs = (dict(quantized_leaves(p["layers"])) for p in (tpk, jpk))
    assert list(ours) == list(theirs)
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    assert diff / sum(qt.packed.numel() for qt in ours.values()) <= 1e-2
    guarded = [i for i, r in enumerate(trep.linears)
               if r.mode == "rtn-guardrail"]
    if rung is None:
        assert trep.guardrail_stats == {} and not guarded
        return
    gs = trep.guardrail_stats
    assert gs["lanes_flagged"] == 1
    if rung == "recovered":
        assert gs["lanes_damp_recovered"] == 1 and not guarded
        return
    assert gs["lanes_rtn_forced"] == 1 and gs["damp_retries"] == 2
    assert len(guarded) == 1
    # the guarded lane's RTN codes and grid, bitwise the JAX package's
    per_layer = len(trep.linears) // len(tpk["layers"])
    i = guarded[0]
    key = f"{i // per_layer}.{trep.linears[i].name}.w"
    for f in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(ours[key], f), getattr(theirs[key], f))


def _toy_member(lanes=3, out=16, din=32, n=64):
    """The JAX suite's toy group: seeded weights, inputs and their Gram."""
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.standard_normal((lanes, out, din)).astype(
        np.float32))
    x = torch.from_numpy(rs.standard_normal((lanes, n, din)).astype(
        np.float32))
    H = torch.einsum("bni,bnj->bij", x, x)
    counts = torch.full((lanes,), n, dtype=torch.int32)
    member = tplan.PlanMember("grp", w, thess.HessianState(H, counts), x,
                              counts, starved=False,
                              names=[f"l{i}" for i in range(lanes)])
    qc = dataclasses.replace(tget_config("opt-proxy", smoke=True).quant,
                             group_size=16, blocksize=16, rpiq_iters=2)
    return qc, member


def _toy_run(qc, member, spec=None):
    report = tplan.QuantReport()
    plan = tplan.build_plan(qc, [member])
    if spec is None:
        res = tplan.execute_plan(qc, plan, report)
    else:
        with tfaults.inject(spec):
            res = tplan.execute_plan(qc, plan, report)
    return res["grp"].w_q, report


@pytest.mark.parametrize("mode", ["nonpsd", "nan"])
def test_untouched_lanes_are_bitwise_the_fault_free_run(mode):
    qc, member = _toy_member()
    clean, report = _toy_run(qc, member)
    assert report.guardrail_stats == {}
    wq, report = _toy_run(qc, member, f"hessian.cholesky@1:{mode}")
    assert torch.equal(wq[1:], clean[1:])
    assert bool(torch.isfinite(wq[0]).all())
    modes = [r.mode for r in report.linears]
    assert modes[0] == ("rtn-guardrail" if mode == "nan" else "rpiq")
    assert modes[1:] == ["rpiq", "rpiq"]


def test_guardrail_off_lets_nan_through():
    qc, member = _toy_member()
    qc = dataclasses.replace(qc, guardrail=False)
    wq, report = _toy_run(qc, member, "hessian.cholesky@1:nan")
    assert not bool(torch.isfinite(wq[0]).all())
    assert bool(torch.isfinite(wq[1:]).all())
    assert report.guardrail_stats == {}


@pytest.mark.parametrize("mode", ["nonpsd", "nan"])
def test_corrupt_stacked_matches_jax(mode):
    rs = np.random.RandomState(1)
    x = rs.standard_normal((3, 40, 24)).astype(np.float32)
    H = np.einsum("bni,bnj->bij", x, x)
    got = thess.corrupt_stacked(torch.from_numpy(H), mode, 0.01).numpy()
    want = np.asarray(jhess.corrupt_stacked(jnp.asarray(H), mode, 0.01))
    np.testing.assert_array_equal(got[1:], H[1:])
    if mode == "nan":
        assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    else:
        assert np.abs(got[0] - want[0]).max() <= 1e-6 * np.abs(want[0]).max()
        assert np.linalg.eigvalsh(got[0].astype(np.float64))[0] < 0


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "packed"):
        return [tree.packed, tree.scales, tree.zeros]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _assert_same_artifact(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _quantize(model, **quant):
    cfg = tget_config("opt-proxy", smoke=True)
    cfg.model.dtype = "float32"
    for k, v in quant.items():
        setattr(cfg.quant, k, v)
    return tquantize(cfg, model["tparams"], model["tc"], device="cpu")


@pytest.mark.parametrize("spec", ["plan.stage1_executor@5",
                                  "plan.stage2_executor@4",
                                  "stream.capture_forward@2"])
def test_kill_then_resume_is_bitwise(model, spec, tmp_path):
    ref, ref_rep = _quantize(model)
    kw = dict(ckpt_dir=str(tmp_path), resume="auto")
    with pytest.raises(tfaults.FaultError) as e:
        with tfaults.inject(spec):
            _quantize(model, **kw)
    assert e.value.site == spec.split("@")[0]
    got, rep = _quantize(model, **kw)
    assert rep.pipeline_stats.get("resumed_at", 0) > 0
    _assert_same_artifact(got, ref)
    assert [r.mode for r in rep.linears] == [r.mode for r in ref_rep.linears]


def test_checkpoint_load_corruption_is_caught(model, tmp_path):
    ref, _ = _quantize(model)
    kw = dict(ckpt_dir=str(tmp_path), resume="auto")
    with pytest.raises(tfaults.FaultError):
        with tfaults.inject("plan.stage1_executor@5"):
            _quantize(model, **kw)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        with tfaults.inject("checkpoint.load@1:corrupt"):
            got, rep = _quantize(model, **kw)
    assert rep.pipeline_stats.get("resumed_at") is None
    _assert_same_artifact(got, ref)


@pytest.mark.parametrize("mode", ["corrupt", "kill"])
def test_checkpoint_load_site_on_artifacts(model, mode, tmp_path):
    path = str(tmp_path / "a.params.pkl")
    tckpt.save_artifact(path, {"w": torch.ones(3)})
    want = (tckpt.CheckpointIntegrityError if mode == "corrupt"
            else tfaults.FaultError)
    with tfaults.inject(f"checkpoint.load@1:{mode}"):
        with pytest.raises(want, match="checkpoint.load"):
            tckpt.load_artifact(path)
        assert tckpt.load_artifact(path)["w"].tolist() == [1.0] * 3

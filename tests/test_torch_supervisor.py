"""The port's ``SupervisedEngine`` against the JAX package's.

opt-proxy smoke at model dtype float32 (the JAX package's initial weights
through ``convert.params_from_numpy``), 4 requests of 8 seeded prompt
tokens and 6 new tokens, ``serve.scheduler=continuous``. A
``serve.engine_step@4`` kill: both packages' supervisors restart once and
finish every request with the fault-free run's greedy tokens, steps and
prompt lengths, and count the same replays and recovered completions
(the JAX engines share one prototype's compiled steps). The port alone,
its fault-free run the oracle, as the JAX suite's
``tests/test_supervisor.py`` holds its own: a watchdog trip on a virtual
clock (the slow tick's tokens absorbed, not replayed twice), restart
exhaustion as a terminal error (its message as the JAX package's),
deadlines that expire during the outage, counters that survive a
rebuild, replays that bypass the queue bound, parameters re-read through
the integrity-checked artifact (and a damaged one failing the recovery).
A kernel fault: ``kernels.pallas_dispatch`` (the int8 cache's attention)
raises out of ``ContinuousEngine.step`` with nothing degraded
(``kernel_degradations`` 0, no kernel backend in ``engine_stats``), and
under the supervisor it is one restart, every request completing with the
fault-free tokens.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import faults as jfaults
from repro.data import MarkovLM as JMarkovLM
from repro.models import transformer as JT
from repro.serving.scheduler import ContinuousEngine as JEngine
from repro.serving.supervisor import EngineRestartExhausted as JExhausted
from repro.serving.supervisor import SupervisedEngine as JSupervised
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tfaults
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.serving.scheduler import ContinuousEngine as TEngine
from repro_torch.serving.supervisor import EngineRestartExhausted
from repro_torch.serving.supervisor import SupervisedEngine

from test_torch_models import to_numpy

_JAX_STEPS = ("_jit_decode", "_jit_decode_guarded", "_jit_insert",
              "_jit_pf_begin", "_jit_pf_step", "_jit_pf_finish")


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()
    yield
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()


@pytest.fixture(scope="module")
def opt():
    jcfg = jget_config("opt-proxy", smoke=True)
    tcfg = tget_config("opt-proxy", smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = "float32"
        cfg.serve.scheduler, cfg.serve.supervise = "continuous", True
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_numpy(to_numpy(jparams)))


def _prompts(n=4, plen=8):
    data = JMarkovLM(256, seed=0)
    return [np.array(data.batch(1, plen)["tokens"]) for _ in range(n)]


def _submit(eng, prompts, mnt=6, **kw):
    return [eng.submit({"tokens": p}, max_new_tokens=mnt, **kw)
            for p in prompts]


def _drain(eng):
    done = {}
    while not eng.idle:
        for f in eng.step().finished:
            done[f.rid] = f
    return done


def _outcome(done, rids):
    return [(done[r].tokens.tolist(), done[r].steps, done[r].prompt_len,
             done[r].status) for r in rids]


def _port(opt, **kw):
    return SupervisedEngine(opt["tcfg"], opt["tparams"], max_len=64,
                            device="cpu", **kw)


def _clean(opt, prompts=None, mnt=6):
    eng = _port(opt)
    rids = _submit(eng, prompts or _prompts(), mnt)
    return _outcome(_drain(eng), rids)


def test_kill_and_recover_matches_jax(opt):
    proto = JEngine(opt["jcfg"], opt["jparams"], max_len=64)

    def shared_engine(self):
        eng = JEngine(self.cfg, self.params, max_len=self.max_len,
                      seed=self.seed, clock=self.clock)
        for name in _JAX_STEPS:
            setattr(eng, name, getattr(proto, name))
        return eng

    runs = []
    for make, mod in (
            (lambda: _port(opt), tfaults),
            (lambda: JSupervised(opt["jcfg"], opt["jparams"], max_len=64),
             jfaults)):
        eng = make()
        if isinstance(eng, JSupervised):
            eng._make_engine = shared_engine.__get__(eng)
            eng._eng = eng._make_engine()
        rids = _submit(eng, _prompts())
        with mod.inject("serve.engine_step@4"):
            done = _drain(eng)
        s = eng.engine_stats()
        runs.append((_outcome(done, rids), s["restarts"],
                     s["replayed_requests"], s["recovered_completions"]))
    assert runs[0] == runs[1]
    assert runs[0][1] == 1 and runs[0][2] >= 1 and runs[0][3] >= 1
    assert runs[0][0] == _clean(opt)


def test_unsupervised_engine_crash_escapes(opt):
    eng = TEngine(opt["tcfg"], opt["tparams"], max_len=64, device="cpu")
    _submit(eng, _prompts(1))
    with tfaults.inject("serve.engine_step@1"):
        with pytest.raises(tfaults.FaultError):
            eng.step()


def test_watchdog_trips_on_a_hung_tick(opt):
    opt["tcfg"].serve.step_timeout_s = 0.5
    box, stride = [0.0], [0.0]

    def clock():
        box[0] += stride[0]
        return box[0]

    try:
        eng = _port(opt, clock=clock)
        rids = _submit(eng, _prompts())
        eng.step()
        eng.step()
        stride[0] = 1.0                 # one tick spans > step_timeout_s
        rep = eng.step()
        stride[0] = 0.0
        done = {f.rid: f for f in rep.finished}
        done.update(_drain(eng))
    finally:
        opt["tcfg"].serve.step_timeout_s = 0.0
    assert eng.stats["watchdog_trips"] == 1 and eng.stats["restarts"] == 1
    assert _outcome(done, rids) == _clean(opt)


def test_restart_exhaustion_is_terminal_as_in_jax(opt):
    msgs = []
    for sup, exc, mod, cfg, params in (
            (lambda c, p: SupervisedEngine(c, p, max_len=64, device="cpu"),
             EngineRestartExhausted, tfaults, opt["tcfg"], opt["tparams"]),
            (lambda c, p: JSupervised(c, p, max_len=64), JExhausted, jfaults,
             opt["jcfg"], opt["jparams"])):
        cfg.serve.max_restarts = 2
        try:
            eng = sup(cfg, params)
            _submit(eng, _prompts(2))
            with mod.inject("serve.engine_step@1+"):
                with pytest.raises(exc, match="serve.max_restarts=2") as e:
                    for _ in range(10):
                        eng.step()
        finally:
            cfg.serve.max_restarts = 3
        assert eng.stats["restarts"] == 2
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_deadline_expired_during_the_outage_times_out(opt):
    box = [0.0]
    eng = _port(opt, clock=lambda: box[0])
    rids = _submit(eng, _prompts(2), mnt=8, timeout_s=5.0)
    for _ in range(3):
        eng.step()
    box[0] = 100.0                      # the outage outlives each deadline
    with tfaults.inject("serve.engine_step@1"):
        rep = eng.step()
    done = {f.rid: f for f in rep.finished}
    assert sorted(done) == sorted(rids)
    assert all(f.status == "timeout" and f.steps > 0 for f in done.values())
    s = eng.engine_stats()
    assert s["timeout_evictions"] == 2 and s["replayed_requests"] == 0
    assert eng.idle


def test_counters_survive_a_restart(opt):
    eng = _port(opt)
    rids = _submit(eng, _prompts())
    with tfaults.inject("serve.decode_step@2", "serve.engine_step@5"):
        done = _drain(eng)
    s = eng.engine_stats()
    assert s["quarantined"] == 1 and s["restarts"] == 1
    statuses = [done[r].status for r in rids]
    assert statuses.count("quarantined") == 1
    assert statuses.count("ok") == len(rids) - 1


def test_replay_bypasses_the_queue_bound(opt):
    cfg = opt["tcfg"]
    cfg.serve.max_queue, cfg.serve.max_batch = 1, 2
    try:
        eng = _port(opt)
        rids = []
        for p in _prompts(3):           # interleaved: the bound never hits
            rids += _submit(eng, [p])
            eng.step()
        with tfaults.inject("serve.engine_step@1"):
            done = _drain(eng)
    finally:
        cfg.serve.max_queue, cfg.serve.max_batch = 0, 8
    s = eng.engine_stats()
    assert s["replayed_requests"] + s["recovered_completions"] >= 3
    assert s["rejections"] == 0
    assert all(done[r].status == "ok" for r in rids)


def test_params_reload_through_the_integrity_check(opt, tmp_path):
    path = str(tmp_path / "p.params.pkl")
    tckpt.save_artifact(path, opt["tparams"])
    eng = SupervisedEngine(opt["tcfg"], None, max_len=64, params_path=path,
                           device="cpu")
    rids = _submit(eng, _prompts())
    with tfaults.inject("serve.engine_step@3"):
        done = _drain(eng)
    assert eng.stats["params_reloads"] == 1
    assert _outcome(done, rids) == _clean(opt)
    # a damaged artifact fails the recovery loudly
    eng = SupervisedEngine(opt["tcfg"], None, max_len=64, params_path=path,
                           device="cpu")
    _submit(eng, _prompts(1))
    with open(path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with tfaults.inject("serve.engine_step@1"):
        with pytest.raises(tckpt.ArtifactIntegrityError):
            eng.step()


def test_kernel_fault_raises_and_is_one_restart(opt):
    cfg = opt["tcfg"]
    cfg.serve.kv_cache = "int8"
    try:
        clean = _clean(opt)
        eng = TEngine(cfg, opt["tparams"], max_len=64, device="cpu")
        _submit(eng, _prompts())
        with tfaults.inject("kernels.pallas_dispatch@3"):
            with pytest.raises(tfaults.FaultError) as e:
                _drain(eng)
        assert e.value.site == "kernels.pallas_dispatch"
        assert eng.engine_stats()["kernel_degradations"] == 0
        assert not any("impl" in k for k in eng.engine_stats())
        sup = _port(opt)
        rids = _submit(sup, _prompts())
        with tfaults.inject("kernels.pallas_dispatch@3"):
            done = _drain(sup)
    finally:
        cfg.serve.kv_cache = "fp16"
    s = sup.engine_stats()
    assert s["restarts"] == 1 and s["kernel_degradations"] == 0
    assert _outcome(done, rids) == clean

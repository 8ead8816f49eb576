"""Sharded quantization (``quant.mesh``) on ``torch.distributed`` against
the single-device port and the single-device JAX package.

(a) ``distributed.sharding.quant_group_sharding`` equals the JAX package's
placement over a grid of mesh shapes, lane counts, Cout and
``expert_stacked`` (both functions read only a mesh's dim names and
sizes, so stand-ins serve and no process group or forced host devices are
needed), and ``spec(kind)`` equals JAX's ``PartitionSpec``.
(b) ``launch.mesh.make_quant_mesh`` at a world of one equals JAX's at one
device on every spec form: the same None and the same printed line.
(c) One gloo world of 4 ranks (``tests/_torch_sharded_checks.py``, one
start-up, ``file://`` rendezvous, one thread a rank) on a (data 2, model
2) mesh:

- ``gptq_block_sharded`` / ``rpiq_block_sharded`` on the JAX package's
  ``_sweep_inputs`` / ``_rpiq_inputs`` (``tests/test_plan_sharded.py``):
  lanes only bitwise the single-device port; rows and both, GPTQ within
  rtol/atol 1e-5, RPIQ with iterations equal, w_q within 1e-6 and finite
  Γ within rtol 1e-5 with the same finite pattern (the JAX package's own
  pins for its sharded twins); every case against the JAX package at
  the port's single-device pins (``tests/test_torch_quant.py``);
- ``psum_hessian`` over the ``data`` group against the JAX Gram of the
  summed rows (≤ 1e-5 of the largest entry);
- opt-proxy smoke under ``quant.mesh=2x2`` and olmoe-1b-7b smoke under
  ``quant.mesh=1x2x2`` with ``quant.pipeline=overlap``: at most 1e-3 of
  all cells differ from the single-device port (rtol 1e-5, atol 1e-6),
  every linear's name and mode equal (the JAX package's
  ``check_sharded_plan_parity``), and the run holds the single-device
  port's pins against the JAX package (``tests/test_torch_pipeline.py``,
  ``tests/test_torch_moe.py``); the groups that ran sharded are counted
  (lanes over ``data``, rows over ``model``, expert lanes over
  ``expert``);
- the opt-proxy run with a NaN Hessian lane (``hessian.cholesky@1:nan``):
  the guardrail ladder's counts and record modes equal the
  single-device port's under the same fault, its cells at the pin above;
- a sharded run killed by the fault plane after its first layer's
  checkpoint (rank 0 writes) and resumed with ``quant.resume=auto``
  (every rank reads) ends bitwise the uninterrupted sharded run;
- every rank's outputs are bitwise rank 0's.

(d) ``launch.quantize`` under ``torch.distributed.run`` (2 ranks,
``quant.mesh=2x1``): rank 0 alone writes, the ranks' packed artifacts are
compared by digest, and the artifact is bitwise the single-process
launcher's (lanes only). (e) ``examples/torch_distributed_quantize.py
--world 2 --device cpu``.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import gptq as jgptq
from repro.core import hessian as jhess
from repro.core import pipeline as jpipe
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.distributed.sharding import quant_group_sharding as jplace
from repro.kernels import ops as jops
from repro.launch.mesh import make_quant_mesh as jmake_quant_mesh
from repro.models import transformer as JT
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tfaults
from repro_torch.core import pipeline as tpipe
from repro_torch.core.quant import quantized_leaves
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.distributed.checkpoint import tree_from_paths, tree_paths
from repro_torch.distributed.sharding import quant_group_sharding as tplace
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.models import transformer as TT

import _torch_sharded_checks as checks
from test_torch_kernels import assert_cells_close, assert_rel
from test_torch_models import rel, to_numpy
from test_torch_moe import _jax_forward_op_by_op

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4


@contextlib.contextmanager
def one_thread():
    """The ranks' one thread for the single-device port's references: a
    CPU product's rounding may follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) placements
# ---------------------------------------------------------------------------

MESHES = [((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 1), ("data", "model")),
          ((1, 2, 2), ("data", "model", "expert")),
          ((2, 1, 2), ("data", "model", "expert")),
          ((2, 2, 2), ("data", "model", "expert")),
          ((1, 1, 4), ("data", "model", "expert")),
          ((4, 2, 1), ("data", "model", "expert"))]


def _stand_ins(shape, names):
    jm = types.SimpleNamespace(axis_names=names,
                               devices=np.empty(shape, object))
    tm = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return jm, tm


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_quant_group_sharding_matches_jax(shape, names):
    jm, tm = _stand_ins(shape, names)
    for lanes in (1, 2, 3, 4, 6, 8, 16, 64):
        for out_dim in (6, 32, 33, 64):
            for stacked in (False, True):
                want = jplace(jm, lanes, out_dim, expert_stacked=stacked)
                got = tplace(tm, lanes, out_dim, expert_stacked=stacked)
                case = (lanes, out_dim, stacked)
                if want is None:
                    assert got is None, case
                    continue
                assert (got.lane_axis, got.row_axis) == \
                    (want.lane_axis, want.row_axis), case
                for kind in ("w", "hessian", "x", "lane"):
                    assert got.spec(kind) == tuple(want.spec(kind)), case
    assert tplace(None, 4, 64) is None and jplace(None, 4, 64) is None


# ---------------------------------------------------------------------------
# (b) the knob at a world of one
# ---------------------------------------------------------------------------

SPECS = ["off", "", "none", "1", "1x1", "1x1x1", "auto", "2x2", "8x1",
         "1x2x2", "2x", "axb", "2x2x2x2", "0x2", "-1x2", "4"]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s or "empty")
def test_make_quant_mesh_matches_jax_at_world_one(spec):
    assert jax.device_count() == 1 and not torch.distributed.is_initialized()
    lines = []
    for make in (jmake_quant_mesh, tmesh.make_quant_mesh):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert make(spec) is None
        lines.append(buf.getvalue())
    assert lines[1] == lines[0]


# ---------------------------------------------------------------------------
# (c) one gloo world of four ranks
# ---------------------------------------------------------------------------

def _jax_run(arch):
    jcfg = jget_config(arch, smoke=True)
    jcfg.model.dtype = "float32"
    jcfg.quant.jit_capture = False
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    jc = jcalib(JMarkovLM(jcfg.model.vocab_size, seed=7), 3, 4, 32)
    jq, jrep = jpipe.quantize_model(jcfg, jparams, jc)
    return jcfg, jparams, jq, jrep


def _sweep_inputs(b=4, out_dim=32, in_dim=64):
    """``tests/test_plan_sharded.py``'s inputs."""
    w = jax.random.normal(jax.random.PRNGKey(0), (b, out_dim, in_dim)) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(1), (b, 256, in_dim))
    h = jnp.einsum("bni,bnj->bij", x, x, precision=jax.lax.Precision.HIGHEST)
    hd = jhess.damped(jhess.HessianState(h, None), 0.01)
    return w, jhess.cholesky_inverse_upper(hd)


def _rpiq_inputs(b=4, out_dim=32, in_dim=64, n=128):
    w, u = _sweep_inputs(b, out_dim, in_dim)
    res1 = jgptq.gptq_quantize_batched(w, u, bits=4, group_size=32,
                                       blocksize=32)
    x = jax.random.normal(jax.random.PRNGKey(5), (b, n, in_dim))
    h = jnp.einsum("bni,bnj->bij", x, x, precision=jax.lax.Precision.HIGHEST)
    hd = jhess.damped(jhess.HessianState(h, None), 0.01)
    return w, x, hd, res1


def _spawn(argvs, timeout):
    """Start every command at once; all must exit 0 (a failed one kills
    the rest)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
            if p.returncode != 0:
                raise AssertionError(f"exit {p.returncode}:\n{outs[-1]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    inp, want = {}, {"runs": {}}
    # the kernel-level inputs and the single-device port's and JAX's results
    w, u = _sweep_inputs()
    inp["sweep/w"], inp["sweep/u"] = np.asarray(w), np.asarray(u)
    want["gptq"] = tuple(np.asarray(a) for a in jops.gptq_block(
        w, u, impl="xla", **checks.SWEEP_KW))
    with one_thread():
        want["gptq_port"] = tuple(t.numpy() for t in tops.gptq_block(
            torch.from_numpy(inp["sweep/w"]),
            torch.from_numpy(inp["sweep/u"]), **checks.SWEEP_KW))
    wr, x, hd, res1 = _rpiq_inputs()
    rargs = (res1.w_q, wr, x, hd, res1.scales, res1.zeros)
    for k, a in zip(("w_init", "w", "x", "hd", "scales", "zeros"), rargs):
        inp[f"rpiq/{k}"] = np.asarray(a)
    for mode, kw in checks.RPIQ_MODES.items():
        want[f"rpiq/{mode}"] = tuple(
            np.asarray(a) for a in jops.rpiq_block_sharded(
                *rargs, mesh=None, impl="xla", **kw))
        with one_thread():
            want[f"rpiq_port/{mode}"] = tuple(
                t.numpy() for t in tops.rpiq_block_sharded(
                    *(torch.from_numpy(inp[f"rpiq/{k}"]) for k in (
                        "w_init", "w", "x", "hd", "scales", "zeros")),
                    mesh=None, **kw))
    hx = np.random.RandomState(3).randn(WORLD, 40, 48).astype(np.float32)
    inp["hessian/x"] = hx
    want["hessian_x"] = hx
    # the whole runs: JAX's, and the single-device port's on the same
    # converted weights and calibration stream
    for key, (arch, _, pipe) in checks.RUNS.items():
        jcfg, jparams, jq, jrep = _jax_run(arch)
        tparams = params_from_numpy(to_numpy(jparams))
        tc = tcalib(TMarkovLM(jcfg.model.vocab_size, seed=7), 3, 4, 32)
        tcfg = checks.run_config(arch)
        tcfg.quant.pipeline = pipe
        with one_thread():
            tq, trep = tpipe.quantize_model(tcfg, tparams, tc, device="cpu")
            if key == "opt":
                with tfaults.inject(checks.GUARD):
                    want["guard"] = tpipe.quantize_model(
                        tcfg, tparams, tc, device="cpu")
        for k, v in tree_paths(tparams):
            inp[f"{key}/params/{k}"] = v.numpy()
        for i, b in enumerate(tc):
            inp[f"{key}/calib/{i}"] = b["tokens"].numpy()
        want["runs"][key] = dict(jcfg=jcfg, jq=jq, jrep=jrep, tcfg=tcfg,
                                 tq=tq, trep=trep, tc=tc)
    np.savez(d / "inputs.npz", **inp)
    helper = str(ROOT / "tests" / "_torch_sharded_checks.py")
    _spawn([[sys.executable, helper, str(r), str(WORLD), str(d)]
            for r in range(WORLD)], timeout=300)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    metas = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return dict(want=want, ranks=ranks, metas=metas)


def _tree(arrays: dict, prefix: str):
    n = len(prefix) + 1
    return tree_from_paths({k[n:]: torch.from_numpy(v)
                            for k, v in arrays.items()
                            if k.startswith(prefix + "/")})


def test_every_rank_bitwise_rank0(world):
    r0 = world["ranks"][0]
    for r, got in enumerate(world["ranks"][1:], 1):
        assert got.keys() == r0.keys()
        for k, v in r0.items():
            if k.startswith("hessian/"):
                continue     # each data group sums its own rows
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
    for key in ("opt", "moe", "guard", "resumed"):
        recs = [m[key]["records"] for m in world["metas"]]
        assert all(rr == recs[0] for rr in recs), key


def test_gptq_block_sharded_lanes_bitwise(world):
    got = world["ranks"][0]
    for name, want in zip(("w_q", "scales", "zeros", "err"),
                          world["want"]["gptq_port"]):
        np.testing.assert_array_equal(got[f"gptq/lanes/{name}"], want,
                                      err_msg=name)


@pytest.mark.parametrize("case", ["rows", "both"])
def test_gptq_block_sharded_rows_match_single(world, case):
    got = world["ranks"][0]
    for name, want in zip(("w_q", "scales", "zeros", "err"),
                          world["want"]["gptq_port"]):
        np.testing.assert_allclose(got[f"gptq/{case}/{name}"], want,
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", list(checks.AXES))
def test_gptq_block_sharded_against_jax(world, case):
    got = world["ranks"][0]
    w_q, scales, zeros, err = world["want"]["gptq"]
    assert_cells_close(got[f"gptq/{case}/w_q"], w_q)
    assert_cells_close(got[f"gptq/{case}/scales"], scales)
    assert_cells_close(got[f"gptq/{case}/zeros"], zeros)
    assert_rel(got[f"gptq/{case}/err"], err, 1e-5)


RPIQ_NAMES = ("w_q", "w_cont", "hist", "proj_loss", "iters")


@pytest.mark.parametrize("mode", list(checks.RPIQ_MODES))
def test_rpiq_block_sharded_lanes_bitwise(world, mode):
    got = world["ranks"][0]
    for name, want in zip(RPIQ_NAMES, world["want"][f"rpiq_port/{mode}"]):
        np.testing.assert_array_equal(got[f"rpiq/{mode}/lanes/{name}"],
                                      want, err_msg=name)


@pytest.mark.parametrize("mode", list(checks.RPIQ_MODES))
@pytest.mark.parametrize("case", ["rows", "both"])
def test_rpiq_block_sharded_row_psum(world, case, mode):
    got = {n: world["ranks"][0][f"rpiq/{mode}/{case}/{n}"]
           for n in RPIQ_NAMES}
    want = dict(zip(RPIQ_NAMES, world["want"][f"rpiq_port/{mode}"]))
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_allclose(got["w_q"], want["w_q"], rtol=1e-6,
                               atol=1e-6)
    fin = np.isfinite(want["hist"])
    np.testing.assert_array_equal(np.isfinite(got["hist"]), fin)
    np.testing.assert_allclose(got["hist"][fin], want["hist"][fin],
                               rtol=1e-5)


@pytest.mark.parametrize("mode", list(checks.RPIQ_MODES))
@pytest.mark.parametrize("case", list(checks.AXES))
def test_rpiq_block_sharded_against_jax(world, case, mode):
    """The single-device port's pins against JAX: on the global
    Hessian's blocks those of ``tests/test_torch_quant.py`` (Γ ≤ 1e-5);
    on each block's own Gram at α 1.0 the single-device port itself parts
    from JAX at a projection tie (8 of 8192 w_q cells, lane 1's Γ from
    round 1 on by 3.8e-3 relative), so there the pins of one such flip
    (``tests/test_torch_pipeline.py``: Γ ≤ 2e-2)."""
    got = world["ranks"][0]
    want = dict(zip(RPIQ_NAMES, world["want"][f"rpiq/{mode}"]))
    assert_cells_close(got[f"rpiq/{mode}/{case}/w_q"], want["w_q"])
    assert_rel(got[f"rpiq/{mode}/{case}/hist"], want["hist"],
               1e-5 if mode == "global" else 2e-2)
    np.testing.assert_array_equal(got[f"rpiq/{mode}/{case}/iters"],
                                  want["iters"])


def test_psum_hessian_sums_the_data_group(world):
    x = world["want"]["hessian_x"]
    for r, got in enumerate(world["ranks"]):
        # a (data 2, model 2) mesh: rank r's data group is {r % 2, r % 2 + 2}
        rows = np.concatenate([x[r % 2], x[r % 2 + 2]])
        st = jhess.accumulate(jhess.init_hessian(rows.shape[-1]),
                              jnp.asarray(rows))
        want = np.asarray(st.H)
        assert int(got["hessian/count"]) == int(st.count) == 80
        assert np.max(np.abs(got["hessian/H"] - want)) <= \
            1e-5 * np.max(np.abs(want))


def _sharded_parity(got_tree, want_tree, got_recs, want_rep):
    mism = total = 0
    got = dict(tree_paths(got_tree))
    for k, a in tree_paths(want_tree):
        a, b = a.float(), got[k].float()
        mism += int((~torch.isclose(b, a, rtol=1e-5, atol=1e-6)).sum())
        total += a.numel()
    assert mism / total <= 1e-3, (mism, total)
    assert [(n, m) for n, m, *_ in got_recs] == \
        [(r.name, r.mode) for r in want_rep.linears]


@pytest.mark.parametrize("key", list(checks.RUNS))
def test_whole_run_matches_single_device_port(world, key):
    run = world["want"]["runs"][key]
    meta = world["metas"][0][key]
    _sharded_parity(_tree(world["ranks"][0], f"{key}/q"), run["tq"],
                    meta["records"], run["trep"])
    calls = {(op, json.dumps(lane), row) for op, lane, row, _, _ in
             meta["sharded"]}
    ops = {"gptq_block_sharded", "rpiq_block_sharded"}
    if key == "opt":
        # q/k/v/o (4 lanes): data x model; fc1 / fc2 (1 lane): model
        assert calls == {(op, json.dumps(lane), "model") for op in ops
                         for lane in ("data", None)}
    else:
        # the stacked expert groups' lanes over expert, rows over model
        assert (("gptq_block_sharded", '"expert"', "model") in calls
                and ("rpiq_block_sharded", '"expert"', "model") in calls)
        assert meta["pipeline"]["spec_captures"] > 0
        assert meta["pipeline"]["moe_spec_layers"] > 0


def test_opt_proxy_sharded_holds_the_jax_pins(world):
    """tests/test_torch_pipeline.py's opt-proxy pins, on the sharded run."""
    run = world["want"]["runs"]["opt"]
    recs = world["metas"][0]["opt"]["records"]
    jl = run["jrep"].linears
    assert [(n, m) for n, m, *_ in recs] == [(r.name, r.mode) for r in jl]
    for (name, _, iters, gamma), b in zip(recs, jl):
        assert iters == b.iters, name
        n = min(len(gamma), len(b.gamma))
        np.testing.assert_allclose(gamma[:n], b.gamma[:n], rtol=1e-3)
    tq = _tree(world["ranks"][0], "opt/q")
    tpacked = tpipe.pack_for_serving(run["tcfg"], tq)
    jpacked = jpipe.pack_for_serving(run["jcfg"], run["jq"])
    _codes_and_logits(tpacked, jpacked, run, 1e-3,
                      lambda toks: JT.forward(run["jcfg"].model, jpacked,
                                              toks)[0])


def test_olmoe_sharded_overlap_holds_the_jax_pins(world):
    """tests/test_torch_moe.py's pins on 3 x 4 x 32, on the sharded run."""
    run = world["want"]["runs"]["moe"]
    meta = world["metas"][0]["moe"]
    jl = run["jrep"].linears
    assert [(n, m) for n, m, *_ in meta["records"]] == \
        [(r.name, r.mode) for r in jl]
    assert meta["dropped"] == run["jrep"].moe_capacity_dropped
    per_layer = len(jl) // 2
    for i, ((name, _, iters, gamma), b) in enumerate(zip(meta["records"],
                                                         jl)):
        d_iters, g_rtol = (0, 1e-3) if i < per_layer else (1, 6e-2)
        assert abs(iters - b.iters) <= d_iters, name
        n = min(len(gamma), len(b.gamma))
        np.testing.assert_allclose(gamma[:n], b.gamma[:n], rtol=g_rtol,
                                   err_msg=name)
    tq = _tree(world["ranks"][0], "moe/q")
    tpacked = tpipe.pack_for_serving(run["tcfg"], tq)
    jpacked = jpipe.pack_for_serving(run["jcfg"], run["jq"])
    _codes_and_logits(tpacked, jpacked, run, 1e-1,
                      lambda toks: _jax_forward_op_by_op(
                          run["jcfg"].model, jpacked, toks))


def _codes_and_logits(tpacked, jpacked, run, logits_pin, jax_forward):
    ours = dict(quantized_leaves(tpacked["layers"]))
    theirs = dict(quantized_leaves(params_from_numpy(
        to_numpy(jpacked))["layers"]))
    assert list(ours) == list(theirs)
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    total = sum(qt.packed.numel() for qt in ours.values())
    assert diff / total <= 1e-2
    toks = run["tc"][-1]["tokens"]
    lt = TT.forward(run["tcfg"].model, tpacked, toks)
    lj = jax_forward(jnp.asarray(toks.numpy()))
    assert rel(lt.numpy(), lj) <= logits_pin


def test_sharded_guardrail_ladder_matches_single_device(world):
    tq, trep = world["want"]["guard"]
    meta = world["metas"][0]["guard"]
    assert meta["guardrail"] == trep.guardrail_stats
    assert meta["guardrail"]["lanes_rtn_forced"] == 1
    _sharded_parity(_tree(world["ranks"][0], "guard/q"), tq,
                    meta["records"], trep)
    assert meta["records"][0][1] == "rtn-guardrail"


def test_sharded_resume_is_bitwise(world):
    meta = world["metas"][0]["resumed"]
    assert meta["killed"] and meta["resumed_at"] == 1
    got, want = world["ranks"][0], world["ranks"][0]
    keys = [k for k in want if k.startswith("opt/q/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got["resumed/q/" + k[len("opt/q/"):]],
                                      want[k], err_msg=k)
    assert meta["records"] == world["metas"][0]["opt"]["records"]


# ---------------------------------------------------------------------------
# (d) the launcher under torch.distributed.run, (e) the example
# ---------------------------------------------------------------------------

def test_launcher_under_torchrun_rank0_writes(tmp_path):
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu"]
    over = [f"train.ckpt_dir={tmp_path / 'none'}"]
    out = _spawn([[sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", "2", "-m",
                   "repro_torch.launch.quantize", *argv, "--out",
                   str(tmp_path / "mesh"), *over, "quant.mesh=2x1"]],
                 timeout=240)[0]
    assert "[quantize] sharded group execution on mesh " \
           "{'data': 2, 'model': 1}" in out
    assert out.count("[quantize] wrote") == 1
    assert "2 ranks' packed artifacts bitwise equal" in out
    with one_thread():
        single, _ = tlaunch_quantize.main(
            argv + ["--out", str(tmp_path / "one")] + over)
    sha = [json.loads(pathlib.Path(p + ".manifest.json").read_text())
           ["sha256"] for p in (str(tmp_path / "mesh" /
                                    "opt-proxy-smoke.params.pkl"), single)]
    assert sha[0] == sha[1]
    assert f"(sha256 {sha[0]})" in out


def test_example_distributed_quantize_runs(tmp_path):
    out = _spawn([[sys.executable, "examples/torch_distributed_quantize.py",
                   "--world", "2", "--device", "cpu"]], timeout=240)[0]
    assert "row-sharded GPTQ == single device (exact)" in out
    assert "row-sharded RPIQ == single device" in out

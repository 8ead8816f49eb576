"""The port's shape-only dry run (``launch/dryrun.py``, ``specs.py``,
``cost.py``, the fake branches of ``kernels/ops.py``) against the JAX
package's ``launch/dryrun.py``, ``specs.py`` and ``hlo_analysis.py``.

- the shape grid: ``SHAPES`` and ``shape_names_for`` equal JAX's for all
  11 archs; ``active_param_count``, ``total_param_count`` and
  ``model_flops_estimate`` equal JAX's exactly, for every arch and shape;
- ``input_specs`` on a mesh of one gives, leaf by leaf by path, JAX's
  global shapes and dtypes from ``repro.launch.specs.input_specs`` on
  ``make_host_mesh()``, at full size (opt-proxy, whisper-large-v3,
  deepseek-v3-671b; the port's tokens and positions are int64 where
  JAX's are int32, its params per-layer lists, stacked here by
  ``convert.stack_layers``);
- a fake pass of the smoke decode and prefill cells of opt-proxy and
  internlm2-1.8b (int8 KV) calls each kernel wrapper as often, at the
  same shapes, as a real CPU run of the same step; no dry run moves
  ``ops.kernel_launches()``; a fake falcon-mamba smoke train pass calls
  the scan's forward (twice a layer under remat) and its backward (once
  a layer) at the shapes the card's step runs them; every fake wrapper
  refuses what its CUDA path refuses and never reaches ``build.load``;
- a dry run under a 2x2 fake world leaves no process group behind;
- opt-proxy's ``train_4k`` cell on a fake world of (data 1, model 2)
  counts at most 0.55 of the (1, 1) cell's FLOPs a rank (every dense
  product, the attention and the vocab head split) and the model axis's
  all-reduces: two a layer forward (o, down), two backward (the inputs
  of q/k/v and of up), the embedding's, the forward's again where
  ``remat=full`` recomputes it;
- recurrentgemma-9b and deepseek-v3-671b smoke train cells on (1, 2)
  against (1, 1): RG-LRU by channels (u all-gathered for rg / ig), MLA
  by heads and the MTP projection by columns, their FLOPs and peaks
  below the whole cell's;
- the olmoe smoke quant cell on 1x2x4 runs its stages at the shard shapes
  ``quant_group_sharding`` gives;
- ``python -m repro_torch.launch.dryrun --arch opt-proxy --shape
  decode_32k`` writes an artifact with the JAX artifact's keys;
- each kernel's work formula (``kernels/work.py``) gives PERF.md's
  printed bound at one shape of its row.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.launch import hlo_analysis as jhlo
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.specs import input_specs as jinput_specs
from repro_torch.configs import registry as treg
from repro_torch.convert import _stack_tensors, stack_layers
from repro_torch.core.pipeline import pack_for_serving
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import build, ops, ref, work
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import transformer as T
from repro_torch.serving.engine import serve_step

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the shape grid and the parameter counts
# ---------------------------------------------------------------------------

def test_shape_grid_matches_jax():
    assert {k: tuple(vars(v).values()) for k, v in treg.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jreg.SHAPES.items()}
    assert treg.ARCH_IDS and set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    for arch in jreg.ARCH_IDS:
        assert treg.shape_names_for(arch) == jreg.shape_names_for(arch)
        for s in jreg.shape_names_for(arch):
            assert treg.input_shapes(arch, s) == treg.SHAPES[s]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch):
    tmc, jmc = treg.get_config(arch).model, jreg.get_config(arch).model
    assert cost.active_param_count(tmc) == jhlo.active_param_count(jmc)
    assert cost.total_param_count(tmc) == jhlo.total_param_count(jmc)
    for s in jreg.SHAPES:
        assert cost.model_flops_estimate(treg.get_config(arch),
                                         treg.SHAPES[s]) == \
            jhlo.model_flops_estimate(jreg.get_config(arch), jreg.SHAPES[s])


# ---------------------------------------------------------------------------
# input_specs against JAX's, at full size
# ---------------------------------------------------------------------------

_INDEX = {"int32": "int64"}     # the port's tokens and positions


def _jax_leaves(tree) -> dict:
    return {jshd._path_str(p): (tuple(x.shape), str(np.dtype(x.dtype)))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[1])}
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        kids = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        kids = [(str(i), v) for i, v in enumerate(tree)]
    out = {}
    for part, child in kids:
        out.update(_port_leaves(child, f"{prefix}/{part}" if prefix
                                else part))
    return out


def _port_as_jax_layout(mc, spec: dict) -> dict:
    """The port's global trees in the JAX layout: layers and caches
    stacked by segment (an encoder-decoder's along its layer axis)."""
    out = {k: spec[k] for k in ("state", "batch", "token", "pos")
           if k in spec}
    if "params" in spec:
        out["params"] = stack_layers(mc, spec["params"])
    if "caches" in spec:
        out["caches"] = (_stack_tensors(spec["caches"])
                         if mc.is_encoder_decoder else
                         stack_layers(mc, {"layers": spec["caches"]})
                         ["blocks"])
    return out


@pytest.mark.parametrize("arch", ["opt-proxy", "whisper-large-v3",
                                  "deepseek-v3-671b"])
def test_input_specs_match_jax_on_a_mesh_of_one(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jmesh = jmake_host_mesh()
    jrules = jshd.make_rules(jmesh, jcfg.parallel)
    with fake_world(1):
        tmesh = make_host_mesh()
        dryrun._groups_ready(tmesh)
        trules = tshd.make_rules(tmesh, tcfg.parallel)
        for s in jreg.shape_names_for(arch):
            with jmesh:
                want = _jax_leaves(jinput_specs(jcfg, jreg.SHAPES[s],
                                                jrules))
            with cost.fake_mode():
                spec = input_specs(tcfg, treg.SHAPES[s], trules)
                got = _port_leaves(_port_as_jax_layout(tcfg.model, spec))
            want = {p: (sh, _INDEX.get(dt, dt) if p.split("/")[0] in
                        ("batch", "token", "pos") else dt)
                    for p, (sh, dt) in want.items()}
            assert got == want, (arch, s, sorted(set(got) ^ set(want))[:6],
                                 [(p, got[p], want[p]) for p in got
                                  if p in want and got[p] != want[p]][:6])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the fake pass against a real CPU run: the kernels' calls
# ---------------------------------------------------------------------------

def _pad32(k: int, gs: int) -> int:
    return k + (-k % math.lcm(32, gs))


@pytest.fixture
def recorded(monkeypatch):
    """The kernels' calls on the CPU (their plain versions), with the
    shapes the kernel would run at (``ops.fake_log``'s)."""
    calls = []

    def rec(name, shapes_of):
        fn = getattr(ref, name)

        def wrapper(*a, **k):
            calls.append((name, shapes_of(*a)))
            return fn(*a, **k)
        monkeypatch.setattr(ref, name, wrapper)

    rec("w4a16_matmul", lambda x, packed, s, z, gs: (
        x.shape[0], packed.shape[0], _pad32(x.shape[1], gs), gs))
    rec("int8_kv_attention", lambda q, kc, ks, vc, vs, kpos, blk, cap: (
        q.shape[0], q.shape[1], q.shape[2], q.shape[3], kc.shape[1], blk))
    for name in ("hessian_accum", "gptq_block", "rpiq_block", "quant_pack",
                 "selective_scan"):
        rec(name, lambda *a: None)
    return calls


@pytest.mark.parametrize("arch,kv", [("opt-proxy", "fp16"),
                                     ("internlm2-1.8b", "int8")])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_fake_pass_calls_kernels_as_a_cpu_run(arch, kv, kind, recorded):
    cfg = treg.get_config(arch, smoke=True)
    cfg.serve.kv_cache = kv
    mc = cfg.model
    b, s = 2, 16
    shape = treg.ShapeSpec("smoke", kind, s, b)
    cdt = "int8" if kv == "int8" else torch.bfloat16
    # the real step on the CPU: packed weights (decode) or float (prefill)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cpu")
    with torch.no_grad():
        if kind == "decode":
            params = pack_for_serving(cfg, params)
            del recorded[:]
            caches = T.init_caches(mc, b, s, "cpu", cdt)
            tok = torch.ones((b,), dtype=torch.int64)
            pos = torch.full((b,), 3, dtype=torch.int64)
            serve_step(cfg, params, tok, pos, caches)
        else:
            T.prefill(mc, params, torch.ones((b, s), dtype=torch.int64), s,
                      cache_dtype=cdt)
    want = [(n, sh) for n, sh in recorded if sh is not None]
    assert not [n for n, sh in recorded if sh is None]
    before = ops.kernel_launches()
    with fake_world(1):
        rules = tshd.make_rules(dryrun._groups_ready(make_host_mesh()),
                                cfg.parallel)
        cc, _ = dryrun.trace_cell(cfg, shape, rules)
    assert ops.kernel_launches() == before
    assert [(n, tuple(sh)) for n, sh, _ in cc.kernel_log] == want
    assert (len(want) > 0) == (kind == "decode")
    assert not dist.is_initialized()


def test_fake_mamba_train_pass_calls_the_scan_and_its_backward():
    cfg = treg.get_config("falcon-mamba-7b", smoke=True)
    mc = cfg.model
    b, s = 4, 16
    before = ops.kernel_launches()
    with fake_world(1):
        rules = tshd.make_rules(dryrun._groups_ready(make_host_mesh()),
                                cfg.parallel)
        cc, _ = dryrun.trace_cell(cfg, treg.ShapeSpec("t", "train", s, b),
                                  rules)
    assert ops.kernel_launches() == before
    shape = (b, s, mc.ssm.expand * mc.d_model, mc.ssm.d_state)
    calls = [(n, tuple(sh)) for n, sh, _ in cc.kernel_log]
    assert calls.count(("selective_scan", shape)) == 2 * mc.num_layers
    assert calls.count(("selective_scan_bwd", shape)) == mc.num_layers
    assert len(calls) == 3 * mc.num_layers
    bwd = [w for n, _, w in cc.kernel_log if n == "selective_scan_bwd"]
    assert bwd[0] == work.selective_scan_backward(*shape, 2, False)


def test_fake_wrappers_refuse_as_the_card_and_never_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"build.load({name!r}) in a fake call")
    monkeypatch.setattr(build, "load", no_build)
    with cost.fake_mode():
        dev = cost.fake_device()
        x = torch.empty((4, 64), dtype=torch.bfloat16, device=dev)
        pk = torch.empty((8, 32), dtype=torch.uint8, device=dev)
        sc = torch.empty((8, 4), device=dev)
        assert ops.w4a16_matmul(x, pk, sc, sc, group_size=16).shape == (4, 8)
        with pytest.raises(ValueError, match="w4a16_matmul"):
            ops.w4a16_matmul_cuda(x, pk, sc, sc, 12)      # odd groups
        with pytest.raises(ValueError, match="hessian_accum"):
            ops.hessian_accum(x, torch.empty((64, 64), device=dev))
        w = torch.empty((2, 64, 64), device=dev)
        with pytest.raises(ValueError, match="not aligned"):
            ops.gptq_block(w, w, group_size=16, blocksize=24)
        with pytest.raises(ValueError, match="quant_pack"):
            ops.quant_pack(torch.empty((8, 12), device=dev),
                           torch.empty((8, 1), device=dev),
                           torch.empty((8, 1), device=dev), group_size=12)
        q = torch.empty((1, 2, 17, 64), dtype=torch.bfloat16, device=dev)
        codes = torch.empty((1, 8, 2, 64), dtype=torch.int8, device=dev)
        scl = torch.empty((1, 8, 2, 1), device=dev)
        kpos = torch.empty((1, 8), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="R <= 16"):
            ops.int8_kv_attention(q, codes, scl, codes, scl, kpos,
                                  kv_block=64)
        u = torch.empty((1, 4, 96), dtype=torch.bfloat16, device=dev)
        f32 = dict(device=dev)
        scan = (u, torch.empty((1, 4, 96), **f32),
                torch.empty((1, 4, 16), **f32),
                torch.empty((1, 4, 16), **f32), torch.empty((96, 16), **f32),
                torch.empty((96,), **f32), torch.empty((1, 96, 16), **f32))
        with pytest.raises(ValueError, match="multiple of 64"):
            ops.selective_scan(*scan)
        with pytest.raises(ValueError, match="selective_scan_bwd.*multiple"):
            ops.selective_scan_bwd_cuda(*scan, torch.empty_like(u))
        hinv = torch.empty((2, 64, 64), device=dev)
        with pytest.raises(ValueError, match="not aligned"):
            ops.rpiq_block(w, w, torch.empty((2, 8, 64), device=dev),
                           hinv, torch.empty((2, 64, 4), device=dev),
                           torch.empty((2, 64, 4), device=dev),
                           group_size=16, block_size=24)
    assert ops.fake_calls()["w4a16_matmul"] >= 1


def test_fake_scan_constants_are_the_kernels():
    src = (ROOT / "src/repro_torch/kernels/csrc/selective_scan.cu"
           ).read_text()
    assert f"constexpr int BD = {ops.SCAN_CHANNELS_PER_BLOCK};" in src
    assert f"constexpr int NMAX = {ops.SCAN_MAX_STATE};" in src
    src = (ROOT / "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
           ).read_text()
    assert f"constexpr int BD = {ops.SCAN_CHANNELS_PER_BLOCK};" in src
    assert f"constexpr int NMAX = {ops.SCAN_MAX_STATE};" in src
    src = (ROOT / "src/repro_torch/kernels/csrc/rpiq_block.cu").read_text()
    assert f"constexpr int WT = {ops.RPIQ_WIDE_TILE};" in src


# ---------------------------------------------------------------------------
# worlds, the quant cell and the command line
# ---------------------------------------------------------------------------

def test_dry_run_on_a_fake_world_leaves_no_group():
    cfg = treg.get_config("opt-proxy", smoke=True)
    before = ops.kernel_launches()
    with fake_world(4):
        mesh = dryrun._groups_ready(make_host_mesh(data=2, model=2))
        cc, _ = dryrun.trace_cell(cfg, treg.ShapeSpec("t", "train", 16, 4),
                                  tshd.make_rules(mesh, cfg.parallel))
        assert dist.is_initialized() and dist.get_world_size() == 4
    assert not dist.is_initialized()
    assert ops.kernel_launches() == before
    assert cc.collectives["all-gather"]["count"] > 0
    assert cc.collectives["all-reduce"]["count"] > 0
    mem = cc.memory_analysis()
    assert mem["temp_size_in_bytes"] > 0 and mem["argument_size_in_bytes"]


def test_train_cell_splits_over_the_model_axis():
    shape = treg.SHAPES["train_4k"]
    cells = {}
    for m in (1, 2):
        cfg = treg.get_config("opt-proxy")
        with fake_world(m):
            mesh = dryrun._groups_ready(make_host_mesh(data=1, model=m))
            cells[m], _ = dryrun.trace_cell(cfg, shape,
                                            tshd.make_rules(mesh,
                                                            cfg.parallel))
    mc = cfg.model
    assert cells[1].collectives == {}
    assert cells[2].flops <= 0.55 * cells[1].flops
    ar = cells[2].collectives["all-reduce"]
    layers, act = mc.num_layers, shape.global_batch * shape.seq_len
    # forward 2 a layer + the embedding's, backward 2 a layer, each of the
    # (B, S, D) f32 activations; the loss's and the norm's are smaller
    assert ar["count"] >= 4 * layers + 1
    assert ar["bytes"] >= (4 * layers + 1) * act * mc.d_model * 4
    peak = {m: c.memory_analysis()["peak_memory_in_bytes"]
            for m, c in cells.items()}
    assert peak[2] < 0.55 * peak[1]


def test_train_cell_splits_mamba_over_the_model_axis():
    """falcon-mamba smoke's train cell on (1, 2): the scan and its
    backward run at d_inner / 2 channels, so the Mamba FLOPs (the scan
    kernels' work) and the step's, and the rank peak, fall below (1, 1)'s;
    the in projection's [u | z] re-blocking is one all-to-all forward,
    one backward and one in the remat recompute a layer."""
    cfg = treg.get_config("falcon-mamba-7b", smoke=True)
    mc = cfg.model
    shape = treg.ShapeSpec("t", "train", 32, 4)
    cells = {}
    for m in (1, 2):
        with fake_world(m):
            mesh = dryrun._groups_ready(make_host_mesh(data=1, model=m))
            cells[m], _ = dryrun.trace_cell(cfg, shape, tshd.make_rules(
                mesh, cfg.parallel))
    scan = {m: sum(w.flop for n, _, w in c.kernel_log
                   if n.startswith("selective_scan"))
            for m, c in cells.items()}
    widths = {m: {sh[2] for n, sh, _ in c.kernel_log} for m, c in
              cells.items()}
    assert widths == {1: {mc.d_inner}, 2: {mc.d_inner // 2}}
    assert 0 < scan[2] <= 0.5 * scan[1]
    assert cells[2].flops + cells[2].kernel_flops < \
        cells[1].flops + cells[1].kernel_flops
    peak = {m: c.memory_analysis()["peak_memory_in_bytes"]
            for m, c in cells.items()}
    assert peak[2] < peak[1]
    a2a = cells[2].collectives["all-to-all"]
    assert a2a["count"] == 3 * mc.num_layers


def _train_cells(arch: str) -> dict:
    """A smoke arch's 4 x 32 train cell on (data 1, model m), m 1 and 2."""
    cfg = treg.get_config(arch, smoke=True)
    cells = {}
    for m in (1, 2):
        with fake_world(m):
            mesh = dryrun._groups_ready(make_host_mesh(data=1, model=m))
            cells[m], _ = dryrun.trace_cell(
                cfg, treg.ShapeSpec("t", "train", 32, 4),
                tshd.make_rules(mesh, cfg.parallel))
    return cells


def test_train_cell_splits_rglru_over_the_model_axis():
    """recurrentgemma smoke's train cell on (1, 2): the RG-LRU runs at
    ``lru_width`` / 2 channels, so the step's FLOPs fall to at most 0.55
    of (1, 1)'s and the rank peak below it; each RG-LRU layer all-gathers
    its u (4 x 32 x 32 bf16) for rg / ig once forward and once in the
    remat recompute, beside the local layer's k and v gathered whole (its
    one kv-head read by both ranks)."""
    cells = _train_cells("recurrentgemma-9b")
    mc = treg.get_config("recurrentgemma-9b", smoke=True).model
    n_rglru = mc.layer_kinds.count("rglru")
    n_local = mc.layer_kinds.count("local")
    assert cells[1].collectives == {}
    assert cells[2].flops <= 0.55 * cells[1].flops
    peak = {m: c.memory_analysis()["peak_memory_in_bytes"]
            for m, c in cells.items()}
    assert peak[2] < peak[1]
    ag = cells[2].collectives["all-gather"]
    u = 4 * 32 * (mc.rglru.lru_width // 2) * 2
    kv = mc.d_model * mc.head_dim // 2 * 4
    assert ag["count"] == 2 * n_rglru + 2 * n_local
    assert ag["bytes"] == 2 * n_rglru * u + 2 * n_local * kv


def test_train_cell_splits_mla_over_the_model_axis():
    """deepseek smoke's train cell on (1, 2): MLA by heads (2 of 4 a
    rank), its experts by E and the MTP projection by its columns, so the
    step's FLOPs fall to at most 0.6 of (1, 1)'s (the latents and the
    routing stay whole) and the rank peak below it; the one all-gather is
    the MTP projection's d/2 columns over S − 1 positions (the MTP head
    runs outside the remat'd super-blocks)."""
    cells = _train_cells("deepseek-v3-671b")
    mc = treg.get_config("deepseek-v3-671b", smoke=True).model
    assert cells[1].collectives == {}
    assert cells[2].flops <= 0.6 * cells[1].flops
    peak = {m: c.memory_analysis()["peak_memory_in_bytes"]
            for m, c in cells.items()}
    assert peak[2] < peak[1]
    ag = cells[2].collectives["all-gather"]
    assert ag["count"] == 1
    assert ag["bytes"] == 4 * 31 * (mc.d_model // 2) * 2


def test_olmoe_smoke_quant_cell_runs_at_shard_shapes():
    art = dryrun.lower_quant_cell("olmoe-1b-7b", "1x2x4", smoke=True)
    assert not dist.is_initialized()
    cfg = treg.get_config("olmoe-1b-7b", smoke=True)
    mc, qc = cfg.model, cfg.quant
    e, d, f = mc.moe.num_experts, mc.d_model, mc.moe.d_ff_expert
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model", "expert"),
                                 shape=(1, 2, 4))
    gs = tshd.quant_group_sharding(mesh, lanes=e, out_dim=f,
                                   expert_stacked=True)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    lane_axes = gs.lane_axis if isinstance(gs.lane_axis, tuple) \
        else (gs.lane_axis,)
    lanes = e // math.prod(sizes[a] for a in lane_axes if a)
    rows = f // (sizes[gs.row_axis] if gs.row_axis else 1)
    assert (art["lane_axis"], art["row_axis"]) == (str(gs.lane_axis),
                                                   str(gs.row_axis))
    assert art["stage1_kernel_shapes"] == [
        ["gptq_block", [lanes, rows, d, qc.group_size, qc.blocksize]]]
    assert art["stage2_kernel_shapes"] == [
        ["rpiq_block", [lanes, rows, d, art["capacity"], qc.blocksize,
                        qc.rpiq_iters]]]
    assert art["stage2_collectives"]["counts"]["all-reduce"] >= 1


# the keys of the JAX artifact whose meaning carries over
_JAX_KEYS = ("per_device_flops", "per_device_bytes", "collectives",
             "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
             "memory_analysis", "model_flops", "useful_fraction",
             "roofline_fraction", "n_devices", "arch", "shape", "mesh",
             "quantized_decode", "total_params", "active_params")


def test_command_line_writes_the_jax_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "opt-proxy", "--shape", "decode_32k",
                    "--out", str(tmp_path)], check=True, env=env,
                   cwd=str(ROOT), timeout=300)
    art = json.loads((tmp_path / "opt-proxy__decode_32k__16x16.json")
                     .read_text())
    assert set(_JAX_KEYS) <= set(art)
    assert art["kernel_calls"]["w4a16_matmul"] > 0
    assert art["memory_analysis"]["peak_memory_in_bytes"] == (
        art["memory_analysis"]["argument_size_in_bytes"]
        + art["memory_analysis"]["temp_size_in_bytes"])
    assert art["collectives"]["counts"]["all-gather"] > 0


# ---------------------------------------------------------------------------
# the work formulas against PERF.md's Bound column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,printed,by", [
    (work.hessian_accum(2048, 18432), 10.39, "operations"),
    (work.gptq_block(4, 768, 768, 128, 128), 0.027, "operations"),
    (work.rpiq_block(4, 768, 768, 512, 128, 5), 0.802, "operations"),
    (work.w4a16_matmul(2180, 16384, 512, 128), 0.0370, "operations"),
    (work.int8_kv_attention(4, 8, 2, 128, 4096, 1), 0.0104, "bytes"),
    (work.quant_pack(2048, 8192, 128), 0.0228, "bytes"),
    (work.selective_scan(4, 512, 8192, 16), 0.0416, "bytes"),
    (work.selective_scan_backward(4, 512, 8192, 16), 0.0881, "operations"),
], ids=["hessian_accum", "gptq_block", "rpiq_block", "w4a16_matmul",
        "int8_kv_attention", "quant_pack", "selective_scan",
        "selective_scan_bwd"])
def test_work_formula_gives_the_printed_bound(w, printed, by):
    digits = len(str(printed).split(".")[1])
    assert round(w.bound_ms(), digits) == printed
    assert w.bound_by() == by

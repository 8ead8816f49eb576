"""The rank side of tests/test_torch_sharded.py: one gloo world, one
process a rank, every check in one start-up.

    python tests/_torch_sharded_checks.py <rank> <world> <dir>

``<dir>/inputs.npz`` holds the inputs the pytest process made (with JAX
and numpy: this file imports no JAX); the ranks meet through
``file://<dir>/rendezvous``. On a (data 2, model 2) mesh every rank runs

- ``ops.gptq_block_sharded`` / ``ops.rpiq_block_sharded`` on the JAX
  package's ``_sweep_inputs`` / ``_rpiq_inputs`` shapes, sharding lanes,
  rows and both;
- ``hessian.psum_hessian`` over the ``data`` group, each rank's Gram from
  its own rows;
- ``quantize_model`` on opt-proxy smoke under ``quant.mesh=2x2``, then
  the same run killed by the fault plane after its first layer's
  checkpoint and resumed (rank 0 writes, every rank reads);
- ``quantize_model`` on olmoe-1b-7b smoke under ``quant.mesh=1x2x2`` and
  ``quant.pipeline=overlap``;
- opt-proxy smoke under ``quant.mesh=2x2`` with a NaN Hessian lane
  (the guardrail ladder to its RTN rung).

Each rank writes ``<dir>/rank<r>.npz`` (every output) and
``<dir>/rank<r>.json`` (reports, and the sharded calls counted by
wrapping the two ops); the pytest process holds them against the
single-device port and the JAX package.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                            # noqa: E402
import torch                                  # noqa: E402
import torch.distributed as dist              # noqa: E402

# the kernel-level cases: name → (lane axis, row axis)
AXES = {"lanes": ("data", None), "rows": (None, "model"),
        "both": ("data", "model")}
SWEEP_KW = dict(bits=4, group_size=32, blocksize=32, symmetric=False)
RPIQ_KW = dict(bits=4, group_size=32, block_size=32, alpha=1.0, t_max=4,
               exact_gram=True)
# stage 2's curvature: the JAX package's sharded tests' (each block's own
# Gram) and the default (the global Hessian's blocks)
RPIQ_MODES = {"exact": RPIQ_KW, "global": dict(RPIQ_KW, exact_gram=False)}
# whole runs: name → (arch, quant.mesh, quant.pipeline)
RUNS = {"opt": ("opt-proxy", "2x2", "serial"),
        "moe": ("olmoe-1b-7b", "1x2x2", "overlap")}
# the resumed run's kill: opt-proxy smoke runs 3 groups a layer, so the 4th
# stage-1 dispatch is layer 2's first, after layer 1's checkpoint
KILL = "plan.stage1_executor@4"
# the guarded run: lane 0 of the first group NaN, so the ladder's rungs
# run on the joined finiteness mask and the lane takes its RTN weights
GUARD = "hessian.cholesky@1:nan"


def run_config(arch: str):
    """The whole runs' configuration, as the pytest process builds it."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    return cfg


def tree_arrays(prefix: str, tree) -> dict:
    from repro_torch.distributed.checkpoint import tree_paths
    return {f"{prefix}/{k}": v.detach().cpu().numpy()
            for k, v in tree_paths(tree)}


def tree_of(inp, prefix: str):
    from repro_torch.distributed.checkpoint import tree_from_paths
    n = len(prefix) + 1
    return tree_from_paths({k[n:]: torch.from_numpy(inp[k])
                            for k in inp.files if k.startswith(prefix + "/")})


def records(report) -> list:
    return [[r.name, r.mode, r.iters, r.gamma] for r in report.linears]


class Counted:
    """Wraps ``ops.gptq_block_sharded`` / ``ops.rpiq_block_sharded``: the
    calls that ran sharded, as ``[op, lane_axis, row_axis, lanes, out]``."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, []
        self.orig = {k: getattr(ops, k) for k in ("gptq_block_sharded",
                                                  "rpiq_block_sharded")}
        for name, fn in self.orig.items():
            setattr(ops, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(w, *a, **kw):
            lane, row = kw.get("lane_axis"), kw.get("row_axis")
            if lane is not None or row is not None:
                self.calls.append([name, lane, row, int(w.shape[0]),
                                   int(w.shape[1])])
            return fn(w, *a, **kw)
        return call

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def kernel_checks(mesh, inp, out: dict) -> None:
    from repro_torch.kernels import ops
    w, u = (torch.from_numpy(inp[k]) for k in ("sweep/w", "sweep/u"))
    for case, (lane, row) in AXES.items():
        res = ops.gptq_block_sharded(w, u, mesh=mesh, lane_axis=lane,
                                     row_axis=row, **SWEEP_KW)
        for name, t in zip(("w_q", "scales", "zeros", "err"), res):
            out[f"gptq/{case}/{name}"] = t.numpy()
    args = [torch.from_numpy(inp[f"rpiq/{k}"])
            for k in ("w_init", "w", "x", "hd", "scales", "zeros")]
    for mode, kw in RPIQ_MODES.items():
        for case, (lane, row) in AXES.items():
            res = ops.rpiq_block_sharded(*args, mesh=mesh, lane_axis=lane,
                                         row_axis=row, **kw)
            for name, t in zip(("w_q", "w_cont", "hist", "proj_loss",
                                "iters"), res):
                out[f"rpiq/{mode}/{case}/{name}"] = t.numpy()


def hessian_check(mesh, inp, out: dict) -> None:
    from repro_torch.core import hessian as hess
    x = torch.from_numpy(inp["hessian/x"][dist.get_rank()])
    st = hess.accumulate(hess.init_hessian(x.shape[-1]), x)
    st = hess.psum_hessian(st, mesh.get_group("data"))
    out["hessian/H"] = st.H.numpy()
    out["hessian/count"] = st.count.numpy()


def whole_run(key: str, inp, extra=None):
    from repro_torch.core.pipeline import quantize_model
    arch, spec, pipe = RUNS[key]
    cfg = run_config(arch)
    cfg.quant.mesh, cfg.quant.pipeline = spec, pipe
    for k, v in (extra or {}).items():
        setattr(cfg.quant, k, v)
    params = tree_of(inp, f"{key}/params")
    n = sum(1 for k in inp.files if k.startswith(f"{key}/calib/"))
    calib = [{"tokens": torch.from_numpy(inp[f"{key}/calib/{i}"])}
             for i in range(n)]
    return quantize_model(cfg, params, calib, device="cpu")


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world)
    from repro_torch.core import faults
    from repro_torch.launch.mesh import make_host_mesh
    inp = np.load(os.path.join(d, "inputs.npz"))
    out, meta = {}, {}
    counted = Counted()
    mesh = make_host_mesh(data=2, model=2)
    kernel_checks(mesh, inp, out)
    counted.take()
    hessian_check(mesh, inp, out)
    for key in RUNS:
        q, rep = whole_run(key, inp)
        out.update(tree_arrays(f"{key}/q", q))
        meta[key] = {"records": records(rep), "sharded": counted.take(),
                     "pipeline": rep.pipeline_stats,
                     "dropped": rep.moe_capacity_dropped}
    with faults.inject(GUARD):
        q, rep = whole_run("opt", inp)
    out.update(tree_arrays("guard/q", q))
    meta["guard"] = {"records": records(rep),
                     "guardrail": rep.guardrail_stats}
    # killed after layer 1's checkpoint, then resumed
    ck = {"ckpt_dir": os.path.join(d, "ck"), "resume": "auto"}
    with faults.inject(KILL):
        try:
            whole_run("opt", inp, ck)
            killed = False
        except faults.FaultError:
            killed = True
    q, rep = whole_run("opt", inp, ck)
    out.update(tree_arrays("resumed/q", q))
    meta["resumed"] = {"killed": killed,
                       "resumed_at": rep.pipeline_stats.get("resumed_at"),
                       "records": records(rep)}
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

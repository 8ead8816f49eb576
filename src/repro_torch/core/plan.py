"""Quantization plan: group same-shape linears, quantize each group at once.

The capture pass yields one :class:`PlanMember` per dense linear;
:func:`build_plan` groups them by ``(out, in, n_last, group_size,
blocksize, bits, symmetric)`` and :func:`execute_plan` runs each group as
one stacked dispatch per stage: stage 1 = damp → Cholesky → GPTQ sweep
(``ops.gptq_block``), stage 2 = the RPIQ closed loop
(``rpiq_refine_batched`` → ``ops.rpiq_block``). A member is one linear or
a stacked slab of S same-shape linears (a routed-MoE layer's experts, one
lane each), and a group's lanes are its members' lanes end to end. An
expert that saw fewer routed tokens than one quant group is *starved*: it
stays in its group as a mask, runs the stages on identity curvature (so
it converges at once and cannot hold the group's closed loop at
``t_max``) and takes the group's batched RTN lane instead (weights and
grid), recorded as ``"rtn-fallback"``. Members whose input dim does not
align with the grid are skipped (kept in float), or RTN-packed where
starved, as in the JAX package.

The stage-1 guardrail ladder (``quant.guardrail``, as in the JAX
package): a lane whose stage-1 output is non-finite (a non-PSD or NaN
Hessian makes its Cholesky NaN) runs stage 1 again with its damping
multiplied by ``guardrail_damp_factor``, up to ``guardrail_retries``
times; every stage-1 op is lane-independent, so the other lanes come out
bitwise as before. A lane still bad after the last rung takes the
group's RTN lane (``"rtn-guardrail"``) and runs stage 2 on sanitized
inputs (its RTN weights and grid, identity curvature), so that its NaN
cannot hold the group's closed loop at ``t_max``. The outcomes are
counted in ``QuantReport.guardrail_stats``. With ``quant.guardrail``
off, a NaN lane passes through to the artifact, as in the JAX package.
The fault sites ``hessian.cholesky`` (a corruption of lane 0's Gram,
``core/hessian.corrupt_stacked``), ``plan.stage1_executor`` and
``plan.stage2_executor`` sit where the JAX package has them.

Under the overlap schedule (core/stream.py) :func:`execute_plan` runs with
``sync=False``: no stage waits for the card (``torch.cuda.synchronize``
would wait for every stream, the side stream's capture-ahead too), so the
stage seconds measure dispatch; each group's report records, whose host
reads would wait, go into ``deferred`` as closures in serial order, and
the scheduler runs them at the step's boundary, so the report equals the
serial one. The ladder's one host read a group (``_finite_lanes``) stays,
as in the JAX package: it waits for the executor's stream only.

Under a mesh (``execute_plan(mesh=)``, ``quant.mesh``) every group whose
lane count or Cout passes the divisibility guards of
``distributed/sharding.quant_group_sharding`` runs sharded, the process
model SPMD: every rank holds the group's whole stacked inputs, damps and
factors the Hessians of its own lanes, and runs both stages through
``ops.gptq_block_sharded`` / ``ops.rpiq_block_sharded`` on its (lane,
row) block, which stays on the rank from stage 1 into stage 2; the
group's weights and grid are gathered once, after the RTN lanes are
selected, and the ladder's finiteness mask and the records' small
outputs are joined on every rank, so the ladder, the starved mask and
the records are the same on every rank. The collectives compose with
``sync=False``: they order themselves after the work that makes their
inputs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import QuantConfig, not_ported
from repro_torch.core import faults
from repro_torch.core import hessian as hess
from repro_torch.core.gptq import (GPTQResult, rtn_quantize,
                                   rtn_quantize_batched)
from repro_torch.core.rpiq import RPIQResult
from repro_torch.distributed.sharding import (QuantGroupSharding,
                                              quant_group_sharding)
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass
class LinearRecord:
    name: str
    shape: Tuple[int, int]           # (out, in)
    gptq_err: float
    gamma: List[float]               # Γ trajectory (Γ[0] = post-stage-1)
    gamma_final: float
    iters: int
    mode: str                        # "rpiq" | "gptq" | "rtn-fallback" |
    #                                  "rtn-guardrail" | "skipped"
    seconds: float


@dataclasses.dataclass
class QuantReport:
    linears: List[LinearRecord] = dataclasses.field(default_factory=list)
    seconds_total: float = 0.0
    seconds_stage1: float = 0.0
    seconds_stage2: float = 0.0
    layer_step_seconds: List[float] = dataclasses.field(default_factory=list)
    # the layer walk's counters (core/stream.py): mode, steps and, after a
    # resume, resumed_at (the first step this run executed)
    pipeline_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per routed-MoE layer, the (token, k) assignments that expert capacity
    # dropped during Hessian capture: they reach no expert's Hessian
    moe_capacity_dropped: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # the guardrail ladder's outcomes ({damp_retries, lanes_flagged,
    # lanes_damp_recovered, lanes_rtn_forced}); empty when it never ran
    guardrail_stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        n = len(self.linears)
        improved = sum(1 for l in self.linears
                       if l.gamma and l.gamma_final < l.gamma[0] * 0.999)
        return (f"{n} linears quantized; stage2 improved {improved}; "
                f"t={self.seconds_total:.1f}s "
                f"(s1={self.seconds_stage1:.1f} s2={self.seconds_stage2:.1f})")


GroupKey = Tuple[int, int, int, int, int, int, bool]


@dataclasses.dataclass
class PlanMember:
    """One linear, or a stacked slab of S same-shape linears.

    Singleton (``names`` None): w_oi (out, in), hessian (in, in), x_last
    (n, in), x_count a scalar, starved a bool. Stacked (``names`` lists
    the S lanes' report names, one per expert): w_oi (S, out, in),
    hessian (S, in, in) / (S,), x_last (S, n, in), x_count (S,), starved a
    bool or an (S,) mask. ``x_count`` None means all n rows are real."""
    name: str
    w_oi: Tensor
    hessian: hess.HessianState
    x_last: Tensor
    x_count: Optional[Tensor] = None
    starved: Any = False
    names: Optional[List[str]] = None

    @property
    def stacked(self) -> bool:
        return self.names is not None

    @property
    def lanes(self) -> int:
        return len(self.names) if self.stacked else 1

    @property
    def lane_names(self) -> List[str]:
        return self.names if self.stacked else [self.name]

    @property
    def wshape(self) -> Tuple[int, int]:
        return tuple(self.w_oi.shape[-2:])

    def starved_mask(self) -> np.ndarray:
        s = np.asarray(self.starved, bool).reshape(-1)
        return np.full(self.lanes, bool(s[0])) if s.size == 1 else s


@dataclasses.dataclass
class QuantGroup:
    key: GroupKey
    members: List[PlanMember]


@dataclasses.dataclass
class QuantPlan:
    groups: List[QuantGroup]
    fallbacks: List[PlanMember]      # grid-unaligned: skipped


@dataclasses.dataclass
class MemberResult:
    """A member's outcome; a stacked member's arrays keep its lane axis."""
    name: str
    w_q: Optional[Tensor]            # (out, in) | (S, out, in); None = skipped
    grid: Optional[Tuple[Tensor, Tensor]]   # stage-1 (scales, zeros)


def build_plan(qc: QuantConfig, members: List[PlanMember]) -> QuantPlan:
    """Group members by shape class; order inside a group is submission
    order, so the scatter back is positional."""
    groups: Dict[GroupKey, List[PlanMember]] = {}
    fallbacks: List[PlanMember] = []
    for m in members:
        out_dim, in_dim = m.wshape
        if in_dim % qc.blocksize or in_dim % qc.group_size:
            fallbacks.append(m)
            continue
        key = (out_dim, in_dim, int(m.x_last.shape[-2]), qc.group_size,
               qc.blocksize, qc.bits, qc.symmetric)
        groups.setdefault(key, []).append(m)
    return QuantPlan([QuantGroup(k, v) for k, v in groups.items()],
                     fallbacks)


def _sync(t: Tensor, sync: bool) -> None:
    if sync and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _gamma_list(hist_row: np.ndarray) -> List[float]:
    return [float(g) for g in hist_row if np.isfinite(g)]


def _as3d(t: Tensor) -> Tensor:
    return t if t.dim() == 3 else t[None]


def _lane_x_counts(m: PlanMember) -> Tensor:
    """(S,) int32 real-row counts of x_last; a starved lane reports n, so
    that with its identity curvature the eq.-13 rescale stays 1."""
    n = m.x_last.shape[-2]
    dev = m.x_last.device
    if m.x_count is None:
        xc = torch.full((m.lanes,), n, dtype=torch.int32, device=dev)
    else:
        xc = m.x_count.to(torch.int32).reshape(-1).expand(m.lanes)
    sv = torch.as_tensor(m.starved_mask(), device=dev)
    return torch.where(sv, torch.full_like(xc, n), xc)


def _lane_hessians(m: PlanMember) -> hess.HessianState:
    """The (S, in, in) curvature fed to the lanes. A starved lane is
    discarded for its RTN lane afterwards but still runs the stages; with
    H = 0 and no tokens its Cholesky is NaN, and a NaN Γ never meets the
    early stop, holding the whole group's closed loop at ``t_max``: it
    runs on the identity (count n) instead and converges at once."""
    H = _as3d(m.hessian.H)
    count = m.hessian.count.to(torch.int32).reshape(-1).expand(m.lanes)
    sv = m.starved_mask()
    if sv.any():
        svt = torch.as_tensor(sv, device=H.device)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        H = torch.where(svt[:, None, None], eye, H)
        count = torch.where(svt, torch.full_like(count, m.x_last.shape[-2]),
                            count)
    return hess.HessianState(H, count)


_GUARDRAIL_KEYS = ("damp_retries", "lanes_flagged", "lanes_damp_recovered",
                   "lanes_rtn_forced")


def _guardrail_stats(report: QuantReport) -> Dict[str, int]:
    for k in _GUARDRAIL_KEYS:
        report.guardrail_stats.setdefault(k, 0)
    return report.guardrail_stats


def _finite_lanes(res1: GPTQResult,
                  gshard: Optional[QuantGroupSharding] = None) -> np.ndarray:
    """(B,) host mask of the lanes whose stage-1 outputs are all finite:
    one sum a lane over each output, which any NaN or Inf poisons (the
    ladder's detector; it waits for stage 1). Under a mesh ``res1`` holds
    this rank's blocks: the rows' sums are added and the lanes joined."""
    tot = (res1.w_q.sum(dim=(-2, -1)) + res1.scales.sum(dim=(-2, -1))
           + res1.zeros.sum(dim=(-2, -1)))
    if gshard is None:
        return torch.isfinite(tot + res1.err).cpu().numpy()
    tot = gshard.psum_rows(tot) + res1.err
    return torch.isfinite(gshard.gather(tot, "lane")).cpu().numpy()


def _mine(gshard: Optional[QuantGroupSharding], t: Tensor,
          kind: str) -> Tensor:
    """This rank's block of a whole tensor of the group (``kind`` as in
    ``distributed/sharding``); the whole tensor without a mesh."""
    return t if gshard is None else gshard.local(t, kind)


def _on_mesh(gshard: Optional[QuantGroupSharding]) -> Dict[str, Any]:
    """The stages' mesh arguments: the single-device stage when no axis
    is set; under a mesh their outputs stay this rank's blocks."""
    if gshard is None:
        return dict(mesh=None)
    return dict(mesh=gshard.mesh, lane_axis=gshard.lane_axis,
                row_axis=gshard.row_axis, gather=False)


def stage1(qc: QuantConfig, w: Tensor, hd: Tensor,
           gshard: Optional[QuantGroupSharding] = None) -> GPTQResult:
    """Stage 1 of a group (the JAX package's ``_make_stage1``,
    ``src/repro/core/plan.py:344``) on its damped Hessians ``hd``
    (``hess.damped``): the factorization, then ``ops.gptq_block_sharded``
    on this rank's (lane, row) block. w (L, out, in) whole; hd (L, in, in)
    or this rank's lanes of it. No host read: the dry run traces it alone
    at shard shapes."""
    u = hess.cholesky_inverse_upper(hd)
    return GPTQResult(*ops.gptq_block_sharded(
        w, u, bits=qc.bits, group_size=qc.group_size,
        symmetric=qc.symmetric, blocksize=qc.blocksize, **_on_mesh(gshard)))


def stage2(qc: QuantConfig, res1: GPTQResult, w: Tensor, x: Tensor,
           hd: Tensor, count: Tensor, x_count: Tensor,
           gshard: Optional[QuantGroupSharding] = None) -> RPIQResult:
    """Stage 2 of a group (the JAX package's ``_make_stage2``,
    ``src/repro/core/plan.py:372``): the block curvature and
    ``ops.rpiq_block_sharded`` from stage 1's (this rank's) outputs; x
    (L, n, in), count / x_count (L,). No host read."""
    return RPIQResult(*ops.rpiq_block_sharded(
        res1.w_q, w, x, hd, res1.scales, res1.zeros, h_count=count,
        x_count=x_count, bits=qc.bits, group_size=qc.group_size,
        symmetric=qc.symmetric, block_size=qc.blocksize,
        alpha=qc.rpiq_alpha, t_max=qc.rpiq_iters,
        early_stop=qc.rpiq_early_stop,
        exact_gram=not qc.rpiq_use_global_hessian, **_on_mesh(gshard)))


def _execute_group(qc: QuantConfig, group: QuantGroup, report: QuantReport,
                   rpiq_enabled: bool, sync: bool = True,
                   deferred: Optional[List[Callable[[], None]]] = None,
                   gshard: Optional[QuantGroupSharding] = None
                   ) -> List[MemberResult]:
    """One stacked dispatch per stage for the whole group: the members'
    lanes concatenated, a stacked member's slab wholesale; stage 1 again
    on the ladder's rungs; ``sync`` and ``deferred`` as in the module
    docstring; ``gshard`` the group's placement on the mesh (module
    docstring)."""
    ms = group.members
    t0 = time.perf_counter()
    w = torch.cat([_as3d(m.w_oi.float()) for m in ms])
    lane_h = [_lane_hessians(m) for m in ms]
    count = torch.cat([h.count for h in lane_h])
    H = torch.cat([h.H for h in lane_h])
    del lane_h
    fspec = faults.poll("hessian.cholesky")
    if fspec is not None:
        H = hess.corrupt_stacked(H, fspec.mode, qc.percdamp)
    # under a mesh, the Hessians of this rank's lanes (all of them when
    # only the rows are sharded)
    H = hess.shard_stacked(hess.HessianState(H, count), gshard).H
    starved = np.concatenate([m.starved_mask() for m in ms])
    qkw = dict(bits=qc.bits, group_size=qc.group_size,
               symmetric=qc.symmetric)

    def rtn_lanes() -> GPTQResult:
        return rtn_quantize_batched(w, **qkw)

    faults.fire("plan.stage1_executor")
    damp = torch.full((H.shape[0],), qc.percdamp, device=w.device)
    hd = hess.damped(hess.HessianState(H, count), damp)
    # the Gram is freed before the factorizations; a rung damps it anew
    # from hd, whose off-diagonal entries are the Gram's exactly, and its
    # diagonal, kept here
    diag = torch.diagonal(H, dim1=-2, dim2=-1).clone()
    del H
    res1 = stage1(qc, w, hd, gshard)
    rtn = rtn_lanes() if starved.any() else None
    guarded = np.zeros(w.shape[0], bool)
    bad0 = bad = ~_finite_lanes(res1, gshard) if qc.guardrail else guarded
    rung = 0
    while bad.any() and rung < qc.guardrail_retries:
        rung += 1
        _guardrail_stats(report)["damp_retries"] += 1
        damp = torch.where(_mine(gshard, torch.as_tensor(
            bad, device=w.device), "lane"),
            damp * qc.guardrail_damp_factor, damp)
        gram = hd.clone()
        torch.diagonal(gram, dim1=-2, dim2=-1).copy_(diag)
        hd = hess.damped(hess.HessianState(gram, count), damp)
        del gram
        res1 = stage1(qc, w, hd, gshard)
        bad = ~_finite_lanes(res1, gshard)
    if bad0.any():
        gs = _guardrail_stats(report)
        gs["lanes_flagged"] += int(bad0.sum())
        gs["lanes_damp_recovered"] += int((bad0 & ~bad).sum())
        gs["lanes_rtn_forced"] += int(bad.sum())
    if bad.any():
        # the per-group RTN rung: stage 2 still runs these lanes, on their
        # RTN weights and grid and identity curvature (the mask below
        # discards their stage-2 output)
        guarded = bad
        if rtn is None:
            rtn = rtn_lanes()
        gl = _mine(gshard, torch.as_tensor(guarded, device=w.device),
                   "lane")
        sel = gl[:, None, None]
        hd = torch.where(sel, torch.eye(hd.shape[-1], dtype=hd.dtype,
                                        device=hd.device), hd)
        res1 = GPTQResult(
            *(torch.where(sel, _mine(gshard, r, "w"), own)
              for r, own in zip(rtn[:3], res1[:3])),
            torch.where(gl, torch.zeros_like(res1.err), res1.err))
    _sync(res1.w_q, sync)
    t1 = time.perf_counter()
    report.seconds_stage1 += t1 - t0

    do_rpiq = rpiq_enabled and qc.rpiq_iters > 0
    res2 = None
    if do_rpiq:
        x = torch.cat([_as3d(m.x_last.float()) for m in ms])
        xc = torch.cat([_lane_x_counts(m) for m in ms])
        faults.fire("plan.stage2_executor")
        res2 = stage2(qc, res1, w, x, hd, count, xc, gshard)
        del x
        _sync(res2.w_q, sync)
        report.seconds_stage2 += time.perf_counter() - t1
    del hd

    # the starved and the guarded lanes take the RTN lane: weights and grid
    w_final = res2.w_q if do_rpiq else res1.w_q
    scales, zeros = res1.scales, res1.zeros
    if rtn is not None:
        sel = _mine(gshard, torch.as_tensor(starved | guarded,
                                            device=w.device),
                    "lane")[:, None, None]
        w_final, scales, zeros = (
            torch.where(sel, _mine(gshard, r, "w"), own)
            for r, own in zip(rtn[:3], (w_final, scales, zeros)))
    outs = [res1.err] + ([res2.loss_history, res2.proj_loss, res2.iters_run]
                         if do_rpiq else [])
    if gshard is not None:
        # the group's one join: every rank continues with the whole group
        w_final, scales, zeros = (gshard.gather(t, "w")
                                  for t in (w_final, scales, zeros))
        outs = [gshard.gather(t, "lane") for t in outs]

    seconds = (time.perf_counter() - t0) / max(1, int((~starved).sum()))
    # a deferred closure holds only the members' names and shapes and the
    # small outputs, so that no weight slab, Hessian or input stays alive
    # until the step's boundary
    named = [(m.lane_names, m.wshape) for m in ms]

    def record() -> None:
        # the host reads wait for the executor: under overlap this runs at
        # the step's boundary
        err1, *rest = (t.cpu().numpy() for t in outs)
        i = 0
        for lane_names, wshape in named:
            for lname in lane_names:
                if starved[i]:
                    rec = LinearRecord(lname, wshape, 0.0, [], 0.0, 0,
                                       "rtn-fallback", 0.0)
                elif guarded[i]:
                    rec = LinearRecord(lname, wshape, 0.0, [], 0.0, 0,
                                       "rtn-guardrail", 0.0)
                elif do_rpiq:
                    hist, ploss, iters = rest
                    rec = LinearRecord(lname, wshape, float(err1[i]),
                                       _gamma_list(hist[i]), float(ploss[i]),
                                       int(iters[i]), "rpiq", seconds)
                else:
                    rec = LinearRecord(lname, wshape, float(err1[i]), [],
                                       0.0, 0, "gptq", seconds)
                report.linears.append(rec)
                i += 1

    if deferred is None:
        record()
    else:
        deferred.append(record)
    results = []
    off = 0
    for m in ms:
        lanes = slice(off, off + m.lanes) if m.stacked else off
        results.append(MemberResult(m.name, w_final[lanes],
                                    (scales[lanes], zeros[lanes])))
        off += m.lanes
    return results


def _execute_fallback(qc: QuantConfig, m: PlanMember, report: QuantReport,
                      deferred: Optional[List[Callable[[], None]]] = None
                      ) -> MemberResult:
    """A member whose input dim does not align with the grid: RTN for its
    starved lanes, skipped (kept in float) otherwise. A starved lane gets
    the per-group grid where in aligns with ``group_size`` (only the
    stages need ``blocksize``), else one whole-row group and no stored
    grid; a stacked member stores a grid only when every lane has one.
    Its records read nothing from the card, but with ``deferred`` they
    queue behind the groups' so that the report keeps serial's order."""
    shape = m.wshape
    aligned = shape[1] % qc.group_size == 0
    gsz = qc.group_size if aligned else shape[1]
    sv = m.starved_mask()
    recs = [LinearRecord(lname, shape, 0.0, [], 0.0, 0,
                         "rtn-fallback" if sv[li] else "skipped", 0.0)
            for li, lname in enumerate(m.lane_names)]
    if deferred is None:
        report.linears.extend(recs)
    else:
        deferred.append(lambda: report.linears.extend(recs))
    if not sv.any():
        return MemberResult(m.name, None, None)
    w = m.w_oi.float()
    if not m.stacked:
        res = rtn_quantize(w, bits=qc.bits, group_size=gsz,
                           symmetric=qc.symmetric)
        return MemberResult(m.name, res.w_q,
                            (res.scales, res.zeros) if aligned else None)
    res = rtn_quantize_batched(w, bits=qc.bits, group_size=gsz,
                               symmetric=qc.symmetric)
    sel = torch.as_tensor(sv, device=w.device)[:, None, None]
    w_q = torch.where(sel, res.w_q, w)          # skipped lanes keep float
    grid = (res.scales, res.zeros) if aligned and bool(sv.all()) else None
    return MemberResult(m.name, w_q, grid)


def execute_plan(qc: QuantConfig, plan: QuantPlan, report: QuantReport,
                 rpiq_enabled: bool = True, sync: bool = True,
                 deferred: Optional[List[Callable[[], None]]] = None,
                 mesh=None) -> Dict[str, MemberResult]:
    """Run every group, then the grid-unaligned members; returns {member
    name → MemberResult}. ``sync=False`` and ``deferred`` are the overlap
    schedule's (module docstring). ``mesh``: a ``DeviceMesh`` from
    ``launch/mesh.py`` turns on sharded group execution (module
    docstring): a group's placement is ``quant_group_sharding(mesh,
    lanes, out, expert_stacked)`` with ``expert_stacked`` when every
    member is a stacked expert slab; the grid-unaligned members run on
    every rank as on one device. ``quant.batched_executor=false``, the
    JAX package's per-linear baseline, is not ported; nor is
    ``quant.gptq_impl`` / ``quant.rpiq_impl`` ``xla``, the JAX package's
    plain route on the accelerator (the port's stages take the
    hand-written kernel on the card, their plain version on the CPU:
    ``auto`` and ``pallas`` both name that one route)."""
    if not qc.batched_executor:
        raise not_ported("quant.batched_executor=false (the per-linear "
                         "baseline)", 9)
    for key in ("gptq_impl", "rpiq_impl"):
        impl = getattr(qc, key)
        if impl == "xla":
            raise not_ported(f"quant.{key}=xla (the plain route on the "
                             f"card)", 9)
        if impl not in ("auto", "pallas"):
            raise ValueError(f"quant.{key} must be auto, pallas or xla, "
                             f"got {impl!r}")
    out: Dict[str, MemberResult] = {}
    for group in plan.groups:
        gshard = quant_group_sharding(
            mesh, sum(m.lanes for m in group.members), group.key[0],
            expert_stacked=all(m.stacked for m in group.members))
        for r in _execute_group(qc, group, report, rpiq_enabled, sync,
                                deferred, gshard):
            out[r.name] = r
    for m in plan.fallbacks:
        out[m.name] = _execute_fallback(qc, m, report, deferred)
    return out

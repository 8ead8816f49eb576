"""Quantization plan: group same-shape linears, quantize each group at once.

The capture pass yields one :class:`PlanMember` per dense linear;
:func:`build_plan` groups them by ``(out, in, n_last, group_size,
blocksize, bits, symmetric)`` and :func:`execute_plan` runs each group as
one stacked dispatch per stage: stage 1 = damp → Cholesky → GPTQ sweep
(``ops.gptq_block``), stage 2 = the RPIQ closed loop
(``rpiq_refine_batched`` → ``ops.rpiq_block``). Members whose input dim
does not align with the grid are skipped (kept in float), as in the JAX
package. A stage-1 lane with non-finite output raises and names its
linear: the JAX package's guardrail ladder is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import QuantConfig
from repro_torch.core import hessian as hess
from repro_torch.core.gptq import gptq_quantize_batched
from repro_torch.core.rpiq import rpiq_refine_batched

Tensor = torch.Tensor


@dataclasses.dataclass
class LinearRecord:
    name: str
    shape: Tuple[int, int]           # (out, in)
    gptq_err: float
    gamma: List[float]               # Γ trajectory (Γ[0] = post-stage-1)
    gamma_final: float
    iters: int
    mode: str                        # "rpiq" | "gptq" | "skipped"
    seconds: float


@dataclasses.dataclass
class QuantReport:
    linears: List[LinearRecord] = dataclasses.field(default_factory=list)
    seconds_total: float = 0.0
    seconds_stage1: float = 0.0
    seconds_stage2: float = 0.0
    layer_step_seconds: List[float] = dataclasses.field(default_factory=list)

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
    """One dense linear: w_oi (out, in), its Hessian, the last batch's
    inputs x_last (n, in)."""
    name: str
    w_oi: Tensor
    hessian: hess.HessianState
    x_last: Tensor

    @property
    def wshape(self) -> Tuple[int, int]:
        return tuple(self.w_oi.shape[-2:])


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
    name: str
    w_q: Optional[Tensor]            # (out, in); None = skipped
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


def _sync(t: Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _gamma_list(hist_row: np.ndarray) -> List[float]:
    return [float(g) for g in hist_row if np.isfinite(g)]


def _execute_group(qc: QuantConfig, group: QuantGroup, report: QuantReport,
                   rpiq_enabled: bool) -> List[MemberResult]:
    """One stacked dispatch per stage for the whole group."""
    ms = group.members
    t0 = time.perf_counter()
    w = torch.stack([m.w_oi.float() for m in ms])
    H = torch.stack([m.hessian.H for m in ms])
    count = torch.stack([m.hessian.count.reshape(()) for m in ms])
    damp = torch.full((len(ms),), qc.percdamp, device=w.device)
    hd = hess.damped(hess.HessianState(H, count), damp)
    u = hess.cholesky_inverse_upper(hd)
    res1 = gptq_quantize_batched(w, u, bits=qc.bits,
                                 group_size=qc.group_size,
                                 blocksize=qc.blocksize,
                                 symmetric=qc.symmetric)
    finite = torch.isfinite(res1.w_q.sum(dim=(1, 2)) + res1.scales.sum(
        dim=(1, 2)) + res1.zeros.sum(dim=(1, 2)) + res1.err).cpu()
    if not bool(finite.all()):
        bad = [m.name for m, ok in zip(ms, finite.tolist()) if not ok]
        raise FloatingPointError(
            f"stage 1 produced non-finite output for {bad} (non-PSD or "
            "NaN Hessian; the guardrail ladder is not ported)")
    _sync(res1.w_q)
    t1 = time.perf_counter()
    report.seconds_stage1 += t1 - t0

    do_rpiq = rpiq_enabled and qc.rpiq_iters > 0
    res2 = None
    if do_rpiq:
        x = torch.stack([m.x_last.float() for m in ms])
        xc = torch.full((len(ms),), x.shape[1], dtype=torch.int32,
                        device=w.device)
        res2 = rpiq_refine_batched(
            res1.w_q, w, x, hd, res1.scales, res1.zeros, h_count=count,
            x_count=xc, bits=qc.bits, group_size=qc.group_size,
            block_size=qc.blocksize, alpha=qc.rpiq_alpha,
            t_max=qc.rpiq_iters, early_stop=qc.rpiq_early_stop,
            exact_gram=not qc.rpiq_use_global_hessian,
            symmetric=qc.symmetric)
        _sync(res2.w_q)
        report.seconds_stage2 += time.perf_counter() - t1

    w_final = res2.w_q if do_rpiq else res1.w_q
    seconds = (time.perf_counter() - t0) / len(ms)
    err1 = res1.err.cpu().numpy()
    if do_rpiq:
        hist = res2.loss_history.cpu().numpy()
        ploss = res2.proj_loss.cpu().numpy()
        iters = res2.iters_run.cpu().numpy()
    for i, m in enumerate(ms):
        if do_rpiq:
            report.linears.append(LinearRecord(
                m.name, m.wshape, float(err1[i]), _gamma_list(hist[i]),
                float(ploss[i]), int(iters[i]), "rpiq", seconds))
        else:
            report.linears.append(LinearRecord(
                m.name, m.wshape, float(err1[i]), [], 0.0, 0, "gptq",
                seconds))
    return [MemberResult(m.name, w_final[i],
                         (res1.scales[i], res1.zeros[i]))
            for i, m in enumerate(ms)]


def execute_plan(qc: QuantConfig, plan: QuantPlan, report: QuantReport,
                 rpiq_enabled: bool = True) -> Dict[str, MemberResult]:
    """Run every group, then record the skipped members; returns
    {member name → MemberResult}."""
    out: Dict[str, MemberResult] = {}
    for group in plan.groups:
        for r in _execute_group(qc, group, report, rpiq_enabled):
            out[r.name] = r
    for m in plan.fallbacks:
        report.linears.append(LinearRecord(m.name, m.wshape, 0.0, [], 0.0, 0,
                                           "skipped", 0.0))
        out[m.name] = MemberResult(m.name, None, None)
    return out

#!/usr/bin/env python
"""Chaos soak of the PyTorch port: seeded randomized fault schedules and
end-to-end invariants, the twin of ``scripts/chaos_soak.py``.

Randomized schedules across the fault plane's sites
(``repro_torch.core.faults``) are driven through (a) a serving trace under
the crash-recovering ``serving/supervisor.SupervisedEngine`` and (b) a
small quantize run with layer-checkpointed resume
(``core/pipeline.quantize_model``, ``quant.resume=auto``), with the JAX
script's invariant checkers, which must hold for any seed:

Serving invariants (per seed):
  S1  every submitted request reaches exactly one terminal status
      (no loss, no double-finish) and the engine drains
  S2  terminal statuses partition the trace:
      ok + timeout + quarantined + cancelled + error + rejected == n
  S3  deterministic replay: every request that finished ``ok`` under
      faults is token-identical to the same request in a fault-free
      replay of the same trace (recovered completions included)
  S4  counters are self-consistent with statuses: quarantined ==
      #quarantined, prefill_failures == #error, timeout_evictions ==
      #timeout, rejections == 0, recovered_completions <= #ok

Quantize invariants (per seed):
  Q1  a walk killed by randomized executor/capture faults (and resume
      loads randomly corrupted via ``checkpoint.load:corrupt``) still
      runs to completion through ``quant.resume=auto`` retries
  Q2  the final packed artifacts are bitwise-identical to an
      uninterrupted fault-free run
  Q3  under randomized ``hessian.cholesky`` corruption the guardrail
      ladder accounts for every flagged lane
      (lanes_flagged == lanes_damp_recovered + lanes_rtn_forced)
      and every packed artifact stays finite

The schedules are the JAX script's for the same seed: both draw from
``numpy.random.default_rng(seed)`` in the same order (:func:`_arm_string`
over the same site tables), the planes seed each site's stream from
(seed, site), and the serving trace advances a virtual clock one unit a
tick.

    PYTHONPATH=src python scripts/torch_chaos_soak.py --seeds 0,1,2 \\
        --smoke --device cpu
    python scripts/torch_chaos_soak.py --seeds 0 --smoke --device cuda

Exit 0 when every invariant holds for every seed; exit 1 listing every
violation otherwise. ``tests/test_torch_fault_scripts.py`` runs seed 7
under the ``chaos`` marker.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import warnings
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.pipeline import (pack_for_serving,  # noqa: E402
                                       quantize_model)
from repro_torch.data import MarkovLM, calibration_batches  # noqa: E402
from repro_torch.distributed.checkpoint import tree_paths  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.supervisor import SupervisedEngine  # noqa: E402

ARCH = "opt-proxy"

# serving sites get small per-hit probabilities drawn from these ranges;
# kernels.pallas_dispatch is armed too (site coverage) but the soak's
# float weights and bf16 cache call neither kernel that passes it
_SERVE_SITES = {
    "serve.engine_step": (0.02, 0.08),
    "serve.decode_step": (0.02, 0.06),
    "serve.prefill_chunk": (0.02, 0.06),
    "kernels.pallas_dispatch": (0.01, 0.05),
}
_QUANT_KILL_SITES = {
    "plan.stage1_executor": (0.02, 0.08),
    "plan.stage2_executor": (0.02, 0.08),
    "stream.capture_forward": (0.02, 0.08),
}


def _arm_string(sites: Dict[str, tuple], rng: np.random.Generator,
                mode: Optional[str] = None) -> str:
    parts = []
    for site, (lo, hi) in sites.items():
        p = float(rng.uniform(lo, hi))
        spec = f"{site}@p{p:.4f}"
        if mode:
            spec += f":{mode}"
        parts.append(spec)
    return ",".join(parts)


def _params(mc, device: str):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return T.init_params(mc, gen, device)


# ---------------------------------------------------------------------------
# Serving soak
# ---------------------------------------------------------------------------

def _serving_setup(smoke: bool, seed: int, device: str):
    cfg = get_config(ARCH, smoke=True)
    cfg.serve = dataclasses.replace(
        cfg.serve, scheduler="continuous", max_batch=2, prefill_chunk=3,
        quantized=False, supervise=True,
        # the soak probes invariants under arbitrarily many crashes, not
        # the restart budget (tests/test_torch_supervisor.py pins that)
        max_restarts=10_000)
    params = _params(cfg.model, device)
    rng = np.random.default_rng(1000 + seed)
    n = 6 if smoke else 12
    reqs = []
    for _ in range(n):
        s0 = int(rng.choice([4, 6, 8]))
        toks = rng.integers(1, cfg.model.vocab_size,
                            size=(1, s0)).astype(np.int64)
        reqs.append(({"tokens": torch.from_numpy(toks)},
                     int(rng.choice([3, 5, 8]))))
    max_len = 8 + 8 + 2
    return cfg, params, reqs, max_len


def run_serving_soak(seed: int, smoke: bool,
                     device: str = "cuda") -> List[str]:
    """Drive one seeded randomized fault schedule through a serving trace
    (virtual clock, one unit per tick, request i submitted at tick 2*i)
    and check invariants S1–S4."""
    cfg, params, reqs, max_len = _serving_setup(smoke, seed, device)
    rng = np.random.default_rng(seed)
    arm = _arm_string(_SERVE_SITES, rng)

    def drive(arm_spec: str):
        clock = [0.0]
        eng = SupervisedEngine(cfg, params, max_len=max_len,
                               clock=lambda: clock[0], device=device)
        statuses: Dict[int, str] = {}
        tokens: Dict[int, np.ndarray] = {}
        finish_count: Dict[int, int] = {}
        rid_of: Dict[int, int] = {}       # request index -> supervisor rid
        tick = 0
        max_ticks = 5000
        ctx = faults.inject(*[s for s in arm_spec.split(",") if s],
                            seed=seed) if arm_spec else \
            contextlib.nullcontext()
        with ctx, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            while len(statuses) < len(reqs):
                for i, (b, mnt) in enumerate(reqs):
                    if i not in rid_of and tick >= 2 * i:
                        rid_of[i] = eng.submit(b, max_new_tokens=mnt)
                if eng.idle and len(rid_of) < len(reqs):
                    tick += 1             # nothing in flight yet: wait
                    clock[0] = float(tick)
                    continue
                rep = eng.step()
                tick += 1
                clock[0] = float(tick)
                for f in rep.finished:
                    finish_count[f.rid] = finish_count.get(f.rid, 0) + 1
                    idx = next(i for i, r in rid_of.items() if r == f.rid)
                    statuses[idx] = f.status
                    tokens[idx] = np.asarray(f.tokens)
                if tick > max_ticks:
                    break
        return {"statuses": statuses, "tokens": tokens,
                "finish_count": finish_count, "rid_of": rid_of,
                "engine_stats": eng.engine_stats(), "idle": eng.idle,
                "ticks": tick}

    ref = drive("")
    got = drive(arm)
    return check_serving(seed, len(reqs), ref, got)


def check_serving(seed: int, n: int, ref: dict, got: dict) -> List[str]:
    """Invariants S1–S4 of a faulted trace ``got`` against its fault-free
    replay ``ref`` (``run_serving_soak``'s drive results)."""
    violations: List[str] = []
    # S1: drained, every request finished exactly once
    if not got["idle"] or len(got["statuses"]) != n:
        violations.append(
            f"[seed {seed}] S1: engine did not drain "
            f"({len(got['statuses'])}/{n} terminal after "
            f"{got['ticks']} ticks)")
    for rid, c in got["finish_count"].items():
        if c != 1:
            violations.append(
                f"[seed {seed}] S1: rid {rid} finished {c} times")
    # S2: statuses partition the trace (no rejections possible here:
    # unbounded queue; cancel not exercised in the soak)
    counts: Dict[str, int] = {}
    for s in got["statuses"].values():
        counts[s] = counts.get(s, 0) + 1
    if sum(counts.values()) != n:
        violations.append(
            f"[seed {seed}] S2: statuses {counts} do not partition n={n}")
    known = {"ok", "timeout", "quarantined", "cancelled", "error"}
    for s in counts:
        if s not in known:
            violations.append(f"[seed {seed}] S2: unknown status {s!r}")
    # S3: deterministic replay — ok outputs token-identical to fault-free
    for i, s in got["statuses"].items():
        if s != "ok":
            continue
        if not np.array_equal(got["tokens"][i], ref["tokens"][i]):
            violations.append(
                f"[seed {seed}] S3: request {i} finished ok but its "
                f"tokens differ from the fault-free replay "
                f"({got['tokens'][i].tolist()} vs "
                f"{ref['tokens'][i].tolist()})")
    # S4: counters self-consistent with statuses
    es = got["engine_stats"]
    for counter, status in (("quarantined", "quarantined"),
                            ("prefill_failures", "error"),
                            ("timeout_evictions", "timeout")):
        if es.get(counter, 0) != counts.get(status, 0):
            violations.append(
                f"[seed {seed}] S4: {counter}={es.get(counter, 0)} but "
                f"#{status} statuses={counts.get(status, 0)}")
    if es.get("rejections", 0) != 0:
        violations.append(
            f"[seed {seed}] S4: rejections={es['rejections']} on an "
            "unbounded queue")
    if es.get("recovered_completions", 0) > counts.get("ok", 0):
        violations.append(
            f"[seed {seed}] S4: recovered_completions="
            f"{es['recovered_completions']} > ok={counts.get('ok', 0)}")
    return violations


# ---------------------------------------------------------------------------
# Quantize soak
# ---------------------------------------------------------------------------

def _quant_cfg(ckpt_dir: str = ""):
    cfg = get_config(ARCH, smoke=True)
    cfg.quant.calib_batches = 2
    cfg.quant.calib_batch_size = 4
    cfg.quant.calib_seq_len = 32
    if ckpt_dir:
        cfg.quant.ckpt_dir = ckpt_dir
        cfg.quant.resume = "auto"
    return cfg


def _calib(cfg):
    data = MarkovLM(cfg.model.vocab_size, seed=7)
    return calibration_batches(data, cfg.quant.calib_batches,
                               cfg.quant.calib_batch_size,
                               cfg.quant.calib_seq_len)


def _packed_leaves(cfg, params, calib, device: str):
    """The packed artifact's leaves (``tree_paths`` of what
    ``save_artifact`` would write: numpy arrays and a packed weight's
    shape, bits and group size) and the report."""
    params_q, report = quantize_model(cfg, params, calib, device=device)
    packed = tree_to_numpy(pack_for_serving(cfg, params_q))
    return [leaf for _, leaf in tree_paths(packed)], report


def _same_leaf(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.reshape(-1).view(np.uint8),
                                   b.reshape(-1).view(np.uint8)))
    return a == b


def check_packed(seed: int, clean: list, leaves: list,
                 attempts: int) -> List[str]:
    """Invariant Q2: ``leaves`` bitwise ``clean``, leaf by leaf."""
    if len(leaves) != len(clean):
        return [f"[seed {seed}] Q2: leaf count {len(leaves)} != "
                f"{len(clean)}"]
    for i, (a, b) in enumerate(zip(clean, leaves)):
        if not _same_leaf(a, b):
            return [f"[seed {seed}] Q2: leaf {i} differs from the "
                    f"fault-free run (after {attempts} attempts)"]
    return []


def run_quantize_soak(seed: int, smoke: bool,
                      device: str = "cuda") -> List[str]:
    """Invariants Q1–Q3 for one seed."""
    violations: List[str] = []
    rng = np.random.default_rng(seed)
    params = _params(get_config(ARCH, smoke=True).model, device)

    clean_leaves, _ = _packed_leaves(_quant_cfg(), params,
                                     _calib(_quant_cfg()), device)

    work = tempfile.mkdtemp(prefix=f"torch_chaos_soak_{seed}_")
    try:
        cfg = _quant_cfg(os.path.join(work, "ckpt"))
        calib = _calib(cfg)
        arm = _arm_string(_QUANT_KILL_SITES, rng)
        # resume loads are occasionally corrupted too: quant.resume=auto
        # must warn + start fresh, never load garbage (Q1 still completes,
        # Q2 still bitwise-identical)
        arm += f",checkpoint.load@p{float(rng.uniform(0.1, 0.3)):.4f}:corrupt"
        attempts = 0
        leaves = None
        with faults.inject(*arm.split(","), seed=seed), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            while attempts < 12 and leaves is None:
                attempts += 1
                try:
                    leaves, _ = _packed_leaves(cfg, params, calib, device)
                except faults.FaultError:
                    continue        # killed; next attempt resumes
        if leaves is None:
            # schedule too hot for the attempt budget: disarm and finish
            # through one last resume (still exercises Q1's resume path)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                leaves, _ = _packed_leaves(cfg, params, calib, device)
        violations += check_packed(seed, clean_leaves, leaves, attempts)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # Q3: randomized Hessian corruption, guardrail accounting
    gcfg = _quant_cfg()
    p = float(rng.uniform(0.15, 0.4))
    mode = "nan" if rng.random() < 0.5 else "nonpsd"
    with faults.inject(f"hessian.cholesky@p{p:.4f}:{mode}", seed=seed), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        leaves, report = _packed_leaves(gcfg, params, _calib(gcfg), device)
    gs = report.guardrail_stats
    if gs.get("lanes_flagged", 0) != (gs.get("lanes_damp_recovered", 0)
                                      + gs.get("lanes_rtn_forced", 0)):
        violations.append(f"[seed {seed}] Q3: guardrail ledger does not "
                          f"balance: {gs}")
    for i, a in enumerate(leaves):
        if (isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating)
                and not np.isfinite(a).all()):
            violations.append(
                f"[seed {seed}] Q3: non-finite values in packed leaf {i} "
                f"under hessian.cholesky@p{p:.4f}:{mode}")
            break
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated seed list")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke scale (the JAX check.sh leg's)")
    ap.add_argument("--serving-only", action="store_true")
    ap.add_argument("--quantize-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    violations: List[str] = []
    for seed in seeds:
        if not args.quantize_only:
            v = run_serving_soak(seed, args.smoke, args.device)
            print(f"[torch_chaos_soak] seed {seed} serving: "
                  f"{'OK' if not v else f'{len(v)} violations'}",
                  flush=True)
            violations += v
        if not args.serving_only:
            v = run_quantize_soak(seed, args.smoke, args.device)
            print(f"[torch_chaos_soak] seed {seed} quantize: "
                  f"{'OK' if not v else f'{len(v)} violations'}",
                  flush=True)
            violations += v
    if violations:
        print(f"[torch_chaos_soak] {len(violations)} invariant violations:")
        for v in violations:
            print(f"  {v}")
        return 1
    print(f"[torch_chaos_soak] all invariants hold over {len(seeds)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

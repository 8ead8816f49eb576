"""The layer walk of the quantizer, serial schedule, with step checkpoints.

An architecture describes itself as a :class:`LayerWalker` — residual
streams plus a flat list of :class:`LayerStep` items, with
:class:`StreamSwitch` fences where the steps move from one stream to
another (the encoder-decoder's ``enc→dec``) — and :func:`run_walker`
drains it: per step capture → plan → execute → scatter → propagate, then
store the quantized layer; a switch runs at its place in the walk. (The JAX package's overlap
schedule is not ported: ``quant.pipeline=overlap`` raises.)

Layer-checkpointed resume (``quant.ckpt_dir`` / ``quant.resume``): at every
step boundary the walker saves the residual streams (the state every later
capture derives from) and the stored quantized subtrees of all completed
steps through ``distributed/checkpoint.py`` (atomic, async writer). A run
restarted with ``quant.resume=auto`` replays the completed switches (which
rebuild what their closures publish, such as the cross-attention memory),
re-stores the checkpointed subtrees and continues from the first
incomplete step on the checkpointed streams,
so its artifacts are bitwise those of an uninterrupted run. A corrupt
checkpoint, or one written under another configuration, warns and the
walk starts fresh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import warnings
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from repro_torch.config import Config, not_ported, to_dict
from repro_torch.core import plan as qplan
from repro_torch.core.plan import LinearRecord, QuantReport
from repro_torch.distributed.checkpoint import (Checkpointer,
                                                CheckpointIntegrityError)


@dataclasses.dataclass
class LayerStep:
    """One quantizable layer. ``apply_fn(params, h, batch_index) -> h_out``
    runs it; ``params`` is its param subtree or a zero-arg callable giving
    it; ``store`` puts the quantized subtree back; ``hs_slot`` names the
    residual stream it consumes and produces."""
    name: str
    params: Union[Dict, Callable[[], Dict]]
    apply_fn: Callable
    hs_slot: str
    store: Callable[[Dict], None]

    def resolve_params(self) -> Dict:
        if callable(self.params):
            self.params = self.params()
        return self.params

    def release_params(self) -> None:
        self.params = None


@dataclasses.dataclass
class StreamSwitch:
    """A fence between stream slots (the encoder → decoder hand-off):
    ``run(streams)`` changes the walker's stream dict, finalizing one
    slot and opening the next, from the fully propagated (quantized)
    upstream state."""
    name: str
    run: Callable[[Dict[str, List[torch.Tensor]]], None]


WalkItem = Union[LayerStep, StreamSwitch]


@dataclasses.dataclass
class LayerWalker:
    """``streams``: slot → per-calibration-batch residual tensors (the
    slots live at walk start; switches add more); ``items`` in walk
    order; ``finalize()`` reassembles the quantized tree from what the
    steps stored."""
    streams: Dict[str, List[torch.Tensor]]
    items: List[WalkItem]
    finalize: Callable[[], Dict]


def _resume_fingerprint(cfg: Config) -> str:
    """The configuration a checkpoint must match to be resumed: all of it
    except the resume and checkpoint knobs themselves."""
    d = to_dict(cfg)
    for k in ("resume", "ckpt_dir", "ckpt_keep"):
        d["quant"].pop(k, None)
    return hashlib.sha256(json.dumps(d, sort_keys=True,
                                     default=str).encode()).hexdigest()[:16]


def _walk_ckpt_tree(streams: Dict[str, List[torch.Tensor]],
                    stored: Dict[str, Dict]) -> Dict:
    """The checkpoint's tree: streams keyed slot/index, stored subtrees
    keyed by step name (both rebuilt from the paths alone)."""
    return {"streams": {slot: {f"{i:03d}": h for i, h in enumerate(hs)}
                        for slot, hs in streams.items()},
            "stored": stored}


def _restore_from_arrays(arrays: Dict[str, torch.Tensor], device
                         ) -> Tuple[Dict[str, List[torch.Tensor]],
                                    Dict[str, Dict]]:
    streams_ix: Dict[str, Dict[int, torch.Tensor]] = {}
    stored: Dict[str, Any] = {}
    for path, t in arrays.items():
        parts = path.split("/")
        if parts[0] == "streams":
            streams_ix.setdefault(parts[1], {})[int(parts[2])] = \
                t.to(device)
        elif parts[0] == "stored":
            node = stored.setdefault(parts[1], {})
            for p in parts[2:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.to(device)
    streams = {slot: [ix[i] for i in range(len(ix))]
               for slot, ix in streams_ix.items()}
    return streams, stored


def _report_state(report: QuantReport, stats: Dict[str, Any]) -> Dict:
    return {"linears": [dataclasses.asdict(l) for l in report.linears],
            "seconds_stage1": report.seconds_stage1,
            "seconds_stage2": report.seconds_stage2,
            "layer_step_seconds": list(report.layer_step_seconds),
            "moe_capacity_dropped": dict(report.moe_capacity_dropped),
            "pipeline_counters": {k: v for k, v in stats.items()
                                  if isinstance(v, int)}}


def _restore_report(report: QuantReport, state: Dict,
                    stats: Dict[str, Any]) -> None:
    report.linears[:] = [LinearRecord(**{**d, "shape": tuple(d["shape"])})
                         for d in state.get("linears", [])]
    report.seconds_stage1 = float(state.get("seconds_stage1", 0.0))
    report.seconds_stage2 = float(state.get("seconds_stage2", 0.0))
    report.layer_step_seconds[:] = state.get("layer_step_seconds", [])
    report.moe_capacity_dropped.update(state.get("moe_capacity_dropped", {}))
    for k, v in state.get("pipeline_counters", {}).items():
        if isinstance(stats.get(k), int):
            stats[k] += v


def _resume(cfg: Config, ckpt: Checkpointer, fp: str, walker: LayerWalker,
            report: QuantReport, stats: Dict[str, Any], verbose: bool
            ) -> Tuple[int, Dict[str, Dict]]:
    """Restore a checkpointed walk; returns (the first step to run, the
    stored subtrees). (0, {}) when the checkpoint cannot be resumed."""
    ckpt_dir = cfg.quant.ckpt_dir
    try:
        arrays, extra = ckpt.load_arrays()
    except CheckpointIntegrityError as e:
        # corruption is another condition than a config mismatch: say
        # which, and redo the walk; the next step boundary overwrites it
        warnings.warn(f"quant.resume=auto: checkpoint in {ckpt_dir!r} is "
                      f"corrupt ({e}) — starting fresh", RuntimeWarning)
        return 0, {}
    if extra.get("walk_fingerprint") != fp:
        warnings.warn(
            f"quant.resume=auto: checkpoint in {ckpt_dir!r} was written by "
            "a different config (fingerprint mismatch) — starting fresh",
            RuntimeWarning)
        return 0, {}
    start = int(extra["item_idx"]) + 1
    device = next(iter(walker.streams.values()))[0].device
    streams, stored = _restore_from_arrays(arrays, device)
    # replay the completed items: a switch rebuilds what its closure
    # publishes from the checkpointed streams, a step re-stores its
    # subtree; then the checkpointed streams overwrite the slots a
    # replayed switch opened at their walk-start values
    walker.streams.clear()
    walker.streams.update(streams)
    for item in walker.items[:start]:
        if isinstance(item, StreamSwitch):
            item.run(walker.streams)
        else:
            item.store(stored[item.name])
            item.release_params()
    walker.streams.update(streams)
    _restore_report(report, extra.get("report", {}), stats)
    stats["resumed_at"] = start
    if verbose:
        print(f"  [resume] restarting at item {start}/{len(walker.items)}")
    return start, stored


def run_walker(cfg: Config, walker: LayerWalker, report: QuantReport,
               verbose: bool = False) -> Dict:
    """Drain the walker serially; returns the finalized quantized tree."""
    from repro_torch.core import pipeline as qpipe   # circular at import only
    qc = cfg.quant
    if qc.pipeline == "overlap":
        raise not_ported("quant.pipeline=overlap", 15)
    if qc.pipeline != "serial":
        raise ValueError(f"quant.pipeline must be 'serial' (or the unported "
                         f"'overlap'), got {qc.pipeline!r}")
    stats: Dict[str, Any] = {"mode": "serial", "steps": 0}
    ckpt, fp, start, stored_snap = None, "", 0, {}
    if qc.ckpt_dir:
        ckpt = Checkpointer(qc.ckpt_dir, keep=qc.ckpt_keep)
        fp = _resume_fingerprint(cfg)
        if qc.resume == "auto" and ckpt.latest_step() is not None:
            start, stored_snap = _resume(cfg, ckpt, fp, walker, report,
                                         stats, verbose)

    def save(idx: int) -> None:
        ckpt.save(idx, _walk_ckpt_tree(walker.streams, stored_snap),
                  extra={"item_idx": idx, "walk_fingerprint": fp,
                         "report": _report_state(report, stats)})

    try:
        for idx, item in enumerate(walker.items[start:], start):
            if isinstance(item, StreamSwitch):
                item.run(walker.streams)
                if ckpt is not None:
                    # a fence: its checkpoint is written before the walk
                    # goes on
                    save(idx)
                    ckpt.wait()
                if verbose:
                    print(f"  {item.name}: switched streams")
                continue
            t_step = time.perf_counter()
            hs = walker.streams[item.hs_slot]
            cap = qpipe.capture_layer(cfg, item, hs)
            new_params, dense_names, plan = qpipe.plan_layer(cfg, item, cap,
                                                             report)
            results = qplan.execute_plan(qc, plan, report)
            qpipe.scatter_layer(new_params, dense_names, cap, results)
            walker.streams[item.hs_slot] = qpipe.propagate_layer(
                item, new_params, hs)
            item.store(new_params)
            item.release_params()
            report.layer_step_seconds.append(time.perf_counter() - t_step)
            stats["steps"] += 1
            if ckpt is not None:
                # the step's layer and the propagated streams become
                # durable (the save copies them to the host first)
                stored_snap[item.name] = new_params
                save(idx)
            if verbose:
                print(f"  {item.name}: {report.summary()}")
    finally:
        # join an in-flight write before returning or raising: an orphaned
        # writer racing a later resume's saves could publish a stale LATEST
        if ckpt is not None:
            ckpt.wait()
    report.pipeline_stats = dict(stats)
    return walker.finalize()

"""The layer walk of the quantizer: one walker, two schedules, with step
checkpoints.

An architecture describes itself as a :class:`LayerWalker` — residual
streams plus a flat list of :class:`LayerStep` items, with
:class:`StreamSwitch` fences where the steps move from one stream to
another (the encoder-decoder's ``enc→dec``) — and :func:`run_walker`
drains it under ``quant.pipeline``:

``serial``
    Per step capture → plan → execute → scatter → propagate, then store
    the quantized layer; each executor stage waits for the card, so the
    report's stage seconds measure compute.

``overlap``
    The JAX package's second schedule, on CUDA streams where the JAX
    package relies on async dispatch. For step *i*:

    1. capture on the main stream, on the post-scatter stream of *i−1*
       (under overlap the exact repair of the speculation in 2), keeping
       the layer's pre-quantization outputs when step *i+1* will
       speculate on them;
    2. capture step *i+1* ahead, speculatively, on a side
       ``torch.cuda.Stream`` that waits for an event recorded after 1,
       queued before the plan so that it runs beside the whole of 3 and
       4 on the main stream. Its Hessians are discarded (1 repeats the
       capture on the quantized stream), so overlap stays bitwise
       serial; of a routed-MoE layer it keeps the routing plans;
    3. plan (a routed-MoE layer's flip repair reads the speculative
       routing plans of the step before's 2, after the main stream has
       waited for the side stream);
    4. execute with no per-stage wait, the report records deferred, and
       scatter;
    5. propagate, store; then the step's report boundary, the
       schedule's only wait: the deferred records are read and the host
       waits for the main stream's propagated outputs, not for the card
       (the side stream's work may stay in flight, across a checkpoint
       save too).

    The JAX package queues the capture ahead after the scatter: async
    dispatch puts no host wait before it there. Here the guardrail
    ladder's host read of each group's stage 1 (core/plan.py) would hold
    it back until the last group's stage 1 had run. The per-site fault
    counts are the same in both orders, so a ``site@N`` schedule still
    stops the walk before the same step's checkpoint.

    A tensor one stream makes and the other reads is marked with
    ``record_stream``, so that the caching allocator does not hand out its
    memory while the other stream may still use it. On the CPU the same
    schedule runs in order, with the same counters.

    Speculation is blocked, and the step counted as a serial fallback by
    reason, when the next item is a fence (``fallback_fence``), when
    ``quant.jit_capture`` is false (``fallback_eager_capture``: the port
    compiles no capture, the key only governs speculation), when the next
    step reads another stream slot (``fallback_cross_slot``) and when its
    repair is unsound (``fallback_repair_unsound``,
    ``pipeline._layer_repair_sound``). A MoE
    layer whose flipped share exceeds ``quant.moe_flip_budget`` re-plans
    serially (``fallback_flip_budget``, core/pipeline.py).

``report.pipeline_stats`` holds the JAX package's counters (both
schedules): steps, speculative captures and their repairs, the fallbacks
by reason and the MoE flip repair's ledger; ``report.layer_step_seconds``
each step's wall.

Layer-checkpointed resume (``quant.ckpt_dir`` / ``quant.resume``): at every
step boundary the walker saves the residual streams (the state every later
capture derives from) and the stored quantized subtrees of all completed
steps through ``distributed/checkpoint.py`` (atomic, async writer). A run
restarted with ``quant.resume=auto`` replays the completed switches (which
rebuild what their closures publish, such as the cross-attention memory),
re-stores the checkpointed subtrees and continues from the first
incomplete step on the checkpointed streams, under either schedule,
so its artifacts are bitwise those of an uninterrupted run. A corrupt
checkpoint, or one written under another configuration, warns and the
walk starts fresh; the fault plane's arming is not part of the
configuration a checkpoint must match (a resumed run disarms it).

Under a mesh (``run_walker(mesh=)``) every rank walks the same items and
the plan's groups run sharded (core/plan.py). Rank 0 alone writes the
step checkpoints; with ``quant.resume=auto`` every rank first waits at a
barrier for the others (so that rank 0 is past the last write of an
earlier run), then reads rank 0's latest checkpoint and restarts at the
same step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config import Config, to_dict
from repro_torch.core import plan as qplan
from repro_torch.core.plan import LinearRecord, QuantReport
from repro_torch.distributed.checkpoint import (Checkpointer,
                                                CheckpointIntegrityError)

PIPELINE_MODES = ("serial", "overlap")


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
    upstream state. No speculation crosses it."""
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
    except the fault plane (a resumed run disarms it) and the resume and
    checkpoint knobs themselves, as in the JAX package."""
    d = to_dict(cfg)
    d.pop("faults", None)
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
            "guardrail_stats": dict(report.guardrail_stats),
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
    report.guardrail_stats.update(state.get("guardrail_stats", {}))
    for layer, n in state.get("moe_capacity_dropped", {}).items():
        report.moe_capacity_dropped[layer] = \
            report.moe_capacity_dropped.get(layer, 0) + int(n)
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


def _new_stats(mode: str) -> Dict[str, Any]:
    """The walk's counters, the JAX package's keys."""
    return {"mode": mode, "steps": 0, "spec_captures": 0, "repairs": 0,
            "serial_fallbacks": 0, "fallback_fence": 0,
            "fallback_cross_slot": 0, "fallback_eager_capture": 0,
            "fallback_repair_unsound": 0, "fallback_flip_budget": 0,
            "moe_spec_layers": 0, "moe_plan_reuses": 0,
            "moe_flip_repairs": 0, "moe_flipped_assignments": 0,
            "moe_assignments": 0, "moe_dropped_tokens": 0}


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of nested lists and tuples (a RoutePlan's fields)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _Streams:
    """The overlap schedule's two CUDA streams: the walk on the main
    (current) stream, the capture-ahead on a side stream. On the CPU every
    method is a no-op: the schedule runs in order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def mark(self, side: bool = False) -> Optional[torch.cuda.Event]:
        """An event after the work the main (or the side) stream has been
        given."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.side if side else self.main)
        return ev

    @contextlib.contextmanager
    def ahead(self, ready: Optional[torch.cuda.Event], inputs
              ) -> Iterator[None]:
        """Run the block on the side stream once ``ready`` has passed;
        ``inputs``, main-stream tensors the block reads, are kept from the
        allocator until the side stream is done with them."""
        if not self.cuda:
            yield
            return
        self.side.wait_event(ready)
        for t in _tensors(inputs):
            t.record_stream(self.side)
        with torch.cuda.stream(self.side):
            yield

    def adopt(self, done: Optional[torch.cuda.Event], tensors) -> None:
        """The main stream waits for ``done`` before it reads ``tensors``,
        which the side stream made; they are kept from the allocator until
        the main stream is done with them."""
        if not self.cuda:
            return
        self.main.wait_event(done)
        for t in _tensors(tensors):
            t.record_stream(self.main)

    def wait_main(self) -> None:
        """The host waits for the main stream's work so far (the step's
        boundary), not for the side stream's."""
        if self.cuda:
            self.mark().synchronize()


def _spec_block(qc, qpipe, item: LayerStep, nxt: Optional[WalkItem]
                ) -> Optional[str]:
    """Why the overlap schedule may not capture ``nxt`` ahead of
    ``item`` (None: it may); ``nxt`` None ends the walk, no fallback."""
    if nxt is None:
        return None
    if isinstance(nxt, StreamSwitch):
        return "fence"
    if not qc.jit_capture:
        return "eager_capture"
    if nxt.hs_slot != item.hs_slot:
        return "cross_slot"
    if not qpipe._layer_repair_sound(nxt.resolve_params()):
        return "repair_unsound"
    return None


def run_walker(cfg: Config, walker: LayerWalker, report: QuantReport,
               verbose: bool = False, mesh=None) -> Dict:
    """Drain the walker under ``quant.pipeline``; returns the finalized
    quantized tree. Both schedules run the same computations in the same
    order on the same inputs (overlap only moves the waits and adds
    discarded speculative work), so their artifacts are bitwise equal.
    ``mesh``: sharded group execution (module docstring)."""
    from repro_torch.core import pipeline as qpipe   # circular at import only
    qc = cfg.quant
    mode = qc.pipeline
    if mode not in PIPELINE_MODES:
        raise ValueError(f"quant.pipeline must be one of {PIPELINE_MODES}, "
                         f"got {mode!r}")
    overlap = mode == "overlap"
    stats = _new_stats(mode)
    ckpt, fp, start, stored_snap = None, "", 0, {}
    if qc.ckpt_dir:
        ckpt = Checkpointer(qc.ckpt_dir, keep=qc.ckpt_keep)
        fp = _resume_fingerprint(cfg)
        if qc.resume == "auto" and mesh is not None:
            dist.barrier()
        if qc.resume == "auto" and ckpt.latest_step() is not None:
            start, stored_snap = _resume(cfg, ckpt, fp, walker, report,
                                         stats, verbose)
        if mesh is not None and dist.get_rank() != 0:
            ckpt = None                 # rank 0 alone writes
    device = next(iter(walker.streams.values()))[0].device
    streams = _Streams(device) if overlap else None
    items = walker.items

    def save(idx: int) -> None:
        ckpt.save(idx, _walk_ckpt_tree(walker.streams, stored_snap),
                  extra={"item_idx": idx, "walk_fingerprint": fp,
                         "report": _report_state(report, stats)})

    spec_for: Optional[LayerStep] = None    # the step captured ahead
    spec_routes = None                      # its MoE routing plans
    spec_done = None                        # the side stream's event
    try:
        for idx, item in enumerate(items[start:], start):
            if isinstance(item, StreamSwitch):
                item.run(walker.streams)
                spec_for = spec_routes = spec_done = None
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
            nxt = items[idx + 1] if idx + 1 < len(items) else None
            block = _spec_block(qc, qpipe, item, nxt) if overlap else None
            can_spec = overlap and nxt is not None and block is None
            # 1. capture; under overlap the exact repair of a speculation
            cap = qpipe.capture_layer(cfg, item, hs, collect_h_out=can_spec)
            routes = None
            if spec_for is item:
                stats["repairs"] += 1
                routes = spec_routes
                if routes is not None:
                    streams.adopt(spec_done, routes)
            spec_for = spec_routes = spec_done = None
            # 2. capture the next step ahead on the side stream, on this
            # step's pre-quantization outputs, queued before the plan so
            # that it overlaps the whole executor
            if can_spec:
                with streams.ahead(streams.mark(), cap.h_out):
                    spec = qpipe.capture_layer(cfg, nxt, cap.h_out,
                                               speculative=True)
                spec_for, spec_routes = nxt, spec.spec_routes
                spec_done = streams.mark(side=True)
                cap.h_out = None
                del spec
                stats["spec_captures"] += 1
            elif block is not None:
                stats["serial_fallbacks"] += 1
                stats["fallback_" + block] += 1
            # 3. plan; speculative routing plans feed the MoE flip repair
            new_params, dense_names, plan = qpipe.plan_layer(
                cfg, item, cap, report, stats=stats, spec_routes=routes)
            del routes
            # 4. execute; under overlap no stage waits, records deferred
            deferred: Optional[List[Callable[[], None]]] = \
                [] if overlap else None
            results = qplan.execute_plan(qc, plan, report, sync=not overlap,
                                         deferred=deferred, mesh=mesh)
            del plan
            # 5. scatter the on-grid weights (and grids) into the subtree
            qpipe.scatter_layer(new_params, dense_names, cap, results)
            del results, cap
            # 6. propagate the quantized layer's outputs, store the layer
            walker.streams[item.hs_slot] = qpipe.propagate_layer(
                item, new_params, hs)
            item.store(new_params)
            item.release_params()
            # the step's boundary: the deferred records, then the host
            # waits for the main stream (speculation stays in flight)
            for record in deferred or ():
                record()
            if overlap:
                streams.wait_main()
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

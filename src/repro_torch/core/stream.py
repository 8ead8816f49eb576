"""The layer walk of the quantizer, serial schedule.

An architecture describes itself as a :class:`LayerWalker` — residual
streams plus a flat list of :class:`LayerStep` items — and
:func:`run_walker` drains it: per step capture → plan → execute → scatter
→ propagate, then store the quantized layer. (The JAX package's overlap
schedule, checkpointing and resume are not ported.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Union

import torch

from repro_torch.config import Config
from repro_torch.core import plan as qplan
from repro_torch.core.plan import QuantReport


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
class LayerWalker:
    streams: Dict[str, List[torch.Tensor]]
    items: List[LayerStep]
    finalize: Callable[[], Dict]


def run_walker(cfg: Config, walker: LayerWalker, report: QuantReport,
               verbose: bool = False) -> Dict:
    """Drain the walker serially; returns the finalized quantized tree."""
    from repro_torch.core import pipeline as qpipe   # circular at import only
    for item in walker.items:
        t_step = time.perf_counter()
        hs = walker.streams[item.hs_slot]
        cap = qpipe.capture_layer(cfg, item, hs)
        new_params, dense_names, plan = qpipe.plan_layer(cfg, item, cap)
        results = qplan.execute_plan(cfg.quant, plan, report)
        qpipe.scatter_layer(new_params, dense_names, results)
        walker.streams[item.hs_slot] = qpipe.propagate_layer(
            item, new_params, hs)
        item.store(new_params)
        item.release_params()
        report.layer_step_seconds.append(time.perf_counter() - t_step)
        if verbose:
            print(f"  {item.name}: {report.summary()}")
    return walker.finalize()

"""The trainer loop: the train step, checkpoints and restarts, straggler
statistics.

The twin of the JAX package's ``training/trainer.py``:

  - ``train(cfg, data_source, device=…)`` runs ``train.steps`` steps of
    ``make_train_step`` from a fresh state (seed ``train.seed``) or from
    the latest checkpoint in ``train.ckpt_dir`` and the data stream's
    position stored with it;
  - a checkpoint every ``train.ckpt_every`` steps, at the last step and at
    the step boundary after a SIGTERM (``SignalCheckpointer``; the run then
    stops), written asynchronously (``train.ckpt_async``), the newest
    ``train.ckpt_keep`` kept; the state in the JAX TrainState's layout and
    paths, so each package's trainer restores the other's checkpoints;
  - a bounded prefetch thread that snapshots the stream's position *with*
    each batch (the thread runs ahead of the steps: the stream's own
    position would over-advance a restart);
  - per-step wall-time EMA with z-score outliers (``StragglerStats``).

With a ``mesh`` (a ``DeviceMesh`` over every rank of the world, from
``launch/mesh.make_host_mesh``; every rank calls ``train``) the run is
SPMD on ``torch.distributed``: every rank starts from the same state (the
same seed) and keeps its block of each leaf
(``sharding.train_state_pspecs`` under ``parallel.fsdp``), draws the same
global batch from the same stream and steps with
``train_step.make_sharded_train_step`` (explicit data parallelism; the
``model`` axis computes its share of the Megatron products, and with
``parallel.sp`` holds the residual's sequence). The
SIGTERM flag is reduced (max) over the world at each step boundary, so
every rank stops at the same step. Every rank reads a checkpoint and keeps
its blocks of it (``Checkpointer.restore(shardings=…)``), whatever mesh
wrote it; rank 0 alone writes, the state gathered whole in the
one-device layout, so the one-device trainers of both packages restore it
too. The returned state is whole, on every rank.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch.distributed as dist

from repro_torch.config import Config
from repro_torch.data.synthetic import DataState
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.checkpoint import (Checkpointer,
                                                SignalCheckpointer,
                                                map_with_path)
from repro_torch.training.train_step import (init_train_state,
                                             make_sharded_train_step,
                                             make_train_step)


@dataclasses.dataclass
class StragglerStats:
    """Wall-time EMA and z-score outliers of the steps."""
    alpha: float = 0.1
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    outliers: List[int] = dataclasses.field(default_factory=list)

    def update(self, step: int, dt: float) -> Optional[float]:
        if self.n >= 5:
            sd = math.sqrt(max(self.var, 1e-12))
            z = (dt - self.mean) / sd if sd > 0 else 0.0
        else:
            z = 0.0
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        if z > 4.0:
            self.outliers.append(step)
            return z
        return None


class Prefetcher:
    """Bounded background prefetch of host batches."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False

        def run():
            for item in it:
                if self._stop:
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def stop(self) -> None:
        self._stop = True
        # unblock a producer waiting on a full queue
        while not self.q.empty():
            self.q.get_nowait()


def train(cfg: Config, data_source, *, device=None, mesh=None,
          verbose: bool = True, restore: bool = True) -> Dict[str, Any]:
    """Run ``train.steps`` steps on ``device`` (default: the CUDA card),
    on one device or, with ``mesh``, on its ranks (module docstring);
    returns ``{"state", "history", "straggler_outliers"}``, the history one
    dict of floats a step run (its metrics, ``step`` and wall ``dt``)."""
    tc = cfg.train
    dev = resolve_device(device)
    state = init_train_state(cfg, dev)
    writer = mesh is None or dist.get_rank() == 0
    verbose = verbose and writer
    if mesh is None:
        specs, shardings = None, None
        step_fn = make_train_step(cfg)
    else:
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.size()} ranks; the world "
                             f"has {dist.get_world_size()}")
        rules = sharding.make_rules(mesh, cfg.parallel)
        specs = sharding.train_state_pspecs(state, rules,
                                            fsdp=cfg.parallel.fsdp)
        shardings = (specs, mesh)
        step_fn = make_sharded_train_step(cfg, rules, specs)

    ckpt = Checkpointer(tc.ckpt_dir, keep=tc.ckpt_keep,
                        async_write=tc.ckpt_async)
    start_step = 0
    if restore and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state, shardings=shardings)
        start_step = int(extra.get("step", 0))
        if hasattr(data_source, "restore") and "data" in extra:
            data_source.restore(DataState(**extra["data"]))
        if verbose:
            print(f"[trainer] restored step {start_step} from {tc.ckpt_dir}",
                  flush=True)
    elif mesh is not None:
        state = sharding.local(state, specs, mesh)
    if mesh is not None:
        state = _own(state)

    sig = SignalCheckpointer().install()
    stats = StragglerStats()
    history: List[Dict[str, float]] = []
    whole = None

    def batches():
        while True:
            b = data_source.batch(tc.global_batch_size, tc.seq_len)
            b = b[0] if isinstance(b, tuple) else b
            st = (data_source.state() if hasattr(data_source, "state")
                  else None)
            yield b, st

    prefetch = Prefetcher(batches(), depth=2)
    try:
        for i, (batch, dstate) in zip(range(start_step, tc.steps),
                                      prefetch):
            whole = None
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            row = {k: float(v) for k, v in metrics.items()}   # waits
            dt = time.perf_counter() - t0
            z = stats.update(i, dt)
            if z is not None and verbose:
                print(f"[trainer] straggler step {i}: {dt*1e3:.1f}ms "
                      f"(z={z:.1f})", flush=True)
            row["step"] = i
            row["dt"] = dt
            history.append(row)
            if verbose and (i % tc.log_every == 0 or i == tc.steps - 1):
                print(f"[trainer] step {i} loss={row['loss']:.4f} "
                      f"lr={row['lr']:.2e} {dt*1e3:.0f}ms", flush=True)
            stop = (sig.requested if mesh is None
                    else sharding.any_rank(sig.requested))
            if (i + 1) % tc.ckpt_every == 0 or stop or i == tc.steps - 1:
                extra: Dict[str, Any] = {"step": i + 1}
                if dstate is not None:
                    extra["data"] = {"seed": dstate.seed,
                                     "step": dstate.step}
                whole = (state if mesh is None
                         else sharding.gather(state, specs, mesh))
                if writer:
                    ckpt.save(i + 1, whole, extra)
                if stop:
                    if verbose:
                        print(f"[trainer] SIGTERM: checkpointed at {i + 1}, "
                              "exiting", flush=True)
                    break
        ckpt.wait()
        if mesh is not None:
            if whole is None:
                whole = sharding.gather(state, specs, mesh)
            state = whole
            dist.barrier()      # rank 0's checkpoint is on disk for all
    finally:
        prefetch.stop()
        sig.uninstall()
    return {"state": state, "history": history,
            "straggler_outliers": stats.outliers}


def _own(tree):
    """Each leaf of a tree of blocks as a tensor of its own (the step
    updates them in place; a view would keep the whole leaf alive)."""
    return map_with_path(tree, lambda _, t: t.clone())

"""Supervised serving: the twin of the JAX package's
``serving/supervisor.py``, engine crash recovery by deterministic replay.

``SupervisedEngine`` wraps :class:`~repro_torch.serving.scheduler.
ContinuousEngine` and survives the engine's death:

- **crash detection**: any exception that leaves ``step()`` (the
  ``serve.engine_step`` fault, a kernel fault at
  ``kernels.pallas_dispatch``, a real launch error), or a watchdog trip: a
  tick whose span on the engine's clock exceeds ``serve.step_timeout_s``;
- **recovery state**: host-side only, kept at tick boundaries from the
  engine's ``StepReport``s: each request's prompt (host copies), budget,
  eos, deadline and every token it emitted. No cache is kept: it is
  recomputed;
- **replay**: a fresh engine (its parameters re-read through the
  integrity-checked ``distributed.checkpoint.load_artifact`` when a
  ``params_path`` is given), and every in-flight request resubmitted in
  submission order as prompt plus emitted prefix, with the remaining
  budget and deadline. Greedy decode is a function of the sequence alone,
  so the continuation is the one the dead engine would have produced, up
  to rounding: the replay prefills the prefix that the dead engine had
  decoded token by token;
- **bounded restarts**: after ``serve.max_restarts`` rebuilds a crash
  raises :class:`EngineRestartExhausted`. ``engine_stats`` counts
  ``restarts``, ``watchdog_trips``, ``replayed_requests``,
  ``recovered_completions`` and ``params_reloads`` beside the engines'
  failure counters, summed over the engines that died.

Sampling (temperature > 0) is not replayed bit for bit: a fresh engine
restarts its requests' generators.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import Config
from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import load_artifact
from repro_torch.serving.scheduler import (ContinuousEngine, FinishedSeq,
                                           StepReport)


class EngineRestartExhausted(RuntimeError):
    """The supervisor reached ``serve.max_restarts`` engine rebuilds: a
    crash loop ends in this error instead of retrying forever."""


class _Tracked:
    """The host-side state of one request in flight."""

    __slots__ = ("rid", "batch", "max_new", "eos_id", "deadline",
                 "prompt_len", "emitted", "replay_base", "replays")

    def __init__(self, rid: int, batch: Dict[str, torch.Tensor],
                 max_new: int, eos_id: int, deadline: float,
                 prompt_len: int):
        self.rid = rid
        self.batch = batch              # host copies of the request
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline        # absolute clock() time
        self.prompt_len = prompt_len
        self.emitted: List[int] = []    # every usable token so far
        self.replay_base: List[int] = []    # the prefix at the last replay
        self.replays = 0


class SupervisedEngine:
    """Crash-recovering wrapper of :class:`ContinuousEngine`, with its
    ``submit`` / ``cancel`` / ``step`` / ``run`` / ``engine_stats``
    surface and request ids that stay valid across rebuilds. Runs on the
    CUDA card unless ``device="cpu"``."""

    def __init__(self, cfg: Config, params: Any = None, *,
                 max_len: Optional[int] = None, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 params_path: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        self.device = device
        if params is None:
            if params_path is None:
                raise ValueError("need params or params_path")
            params = self._load(params_path)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.seed = seed
        self.clock = clock or time.monotonic
        self.params_path = params_path
        self._tracked: Dict[int, _Tracked] = {}
        self._sup_of: Dict[int, int] = {}   # engine rid -> supervisor rid
        self._eng_of: Dict[int, int] = {}   # supervisor rid -> engine rid
        self._next_rid = 0
        self.stats: Dict[str, int] = {
            "restarts": 0, "watchdog_trips": 0, "replayed_requests": 0,
            "recovered_completions": 0, "params_reloads": 0,
        }
        # the failure counters of the engines that died
        self._stats_acc: Dict[str, int] = {}
        self._eng = self._make_engine()

    def _load(self, path: str) -> Any:
        return params_from_numpy(load_artifact(path),
                                 resolve_device(self.device))

    def _make_engine(self) -> ContinuousEngine:
        return ContinuousEngine(self.cfg, self.params, max_len=self.max_len,
                                seed=self.seed, clock=self.clock,
                                device=self.device)

    @property
    def lanes(self) -> int:
        return self._eng.lanes

    @property
    def active(self) -> int:
        return self._eng.active

    @property
    def idle(self) -> bool:
        return self._eng.idle

    def engine_stats(self) -> Dict[str, Any]:
        """The live engine's counters plus those of the engines that died,
        and the supervisor's own: nothing resets at a rebuild."""
        s: Dict[str, Any] = dict(self._stats_acc)
        for k, v in self._eng.stats.items():
            s[k] = s.get(k, 0) + v
        s.update(self.stats)
        return s

    @staticmethod
    def _prompt_positions(batch: Dict[str, Any]) -> int:
        """Decoder prompt positions, frontend embeddings included (an
        encoder-decoder's frames feed the encoder and add none)."""
        n = int(batch["tokens"].shape[1])
        if "frames" not in batch and batch.get("embeds") is not None:
            n += int(batch["embeds"].shape[1])
        return n

    def submit(self, batch: Dict[str, Any], *,
               max_new_tokens: Optional[int] = None, eos_id: int = -1,
               timeout_s: Optional[float] = None) -> int:
        """``ContinuousEngine.submit``'s contract (``QueueFullError`` on a
        full queue), returning a supervisor rid."""
        mnt = max_new_tokens or self.cfg.serve.max_new_tokens
        tmo = self.cfg.serve.request_timeout_s if timeout_s is None \
            else timeout_s
        # the engine first: a rejected request is never tracked
        eng_rid = self._eng.submit(batch, max_new_tokens=mnt, eos_id=eos_id,
                                   timeout_s=tmo)
        deadline = self.clock() + tmo if tmo and tmo > 0 else float("inf")
        host = {k: v.cpu().clone() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))
                for k, v in batch.items() if v is not None}
        rid = self._next_rid
        self._next_rid += 1
        self._tracked[rid] = _Tracked(rid, host, mnt, eos_id, deadline,
                                      self._prompt_positions(host))
        self._sup_of[eng_rid] = rid
        self._eng_of[rid] = eng_rid
        return rid

    def cancel(self, rid: int) -> Optional[FinishedSeq]:
        t = self._tracked.get(rid)
        eng_rid = self._eng_of.get(rid)
        if t is None or eng_rid is None:
            return None
        f = self._eng.cancel(eng_rid)
        if f is None:                   # the engine lost it
            f = FinishedSeq(eng_rid, np.zeros((0,), np.int32), 0, 0,
                            "cancelled")
        return self._translate_finished(f)

    def step(self) -> StepReport:
        """One supervised tick: the engine's tick; on an exception or a
        watchdog trip, a rebuild and a replay. A slow tick's report is
        absorbed first, so its tokens are not replayed twice."""
        t0 = self.clock()
        try:
            rep = self._eng.step()
        except Exception as e:          # noqa: BLE001 — any exception
            return self._recover(e)     # that leaves step() is a crash
        rep = self._absorb(rep)
        wd = self.cfg.serve.step_timeout_s
        if wd and wd > 0 and (self.clock() - t0) > wd:
            self.stats["watchdog_trips"] += 1
            rec = self._recover(None)
            return rep._replace(finished=rep.finished + rec.finished,
                                active=rec.active)
        return rep

    def run(self) -> Dict[int, FinishedSeq]:
        """Tick until every tracked request has finished."""
        done: Dict[int, FinishedSeq] = {}
        while not self.idle:
            for f in self.step().finished:
                done[f.rid] = f
        return done

    def _absorb(self, rep: StepReport) -> StepReport:
        """Record the emitted tokens and translate the report to
        supervisor rids."""
        sup = self._sup_of
        first_tokens: List[tuple] = []
        decoded: List[tuple] = []
        for erid, tok in rep.first_tokens:
            rid = sup.get(erid)
            if rid is None:
                continue
            t = self._tracked[rid]
            t.emitted.append(int(tok))
            # a replayed request's first token from the fresh engine
            # continues its sequence: reported as decoded
            if t.replay_base:
                decoded.append((rid, tok))
            else:
                first_tokens.append((rid, tok))
        for erid, tok in rep.decoded:
            rid = sup.get(erid)
            if rid is None:
                continue
            self._tracked[rid].emitted.append(int(tok))
            decoded.append((rid, tok))
        finished = [f for f in (self._translate_finished(f)
                                for f in rep.finished) if f is not None]
        admitted = [sup[e] for e in rep.admitted if e in sup]
        prefill_rid = sup.get(rep.prefill_rid) \
            if rep.prefill_rid is not None else None
        return StepReport(admitted, prefill_rid, first_tokens, decoded,
                          finished, rep.active, rep.lanes)

    def _translate_finished(self, f: FinishedSeq) -> Optional[FinishedSeq]:
        rid = self._sup_of.pop(f.rid, None)
        if rid is None:
            return None
        self._eng_of.pop(rid, None)
        t = self._tracked.pop(rid, None)
        if t is None:
            return None
        tokens = np.concatenate([np.asarray(t.replay_base, np.int32),
                                 np.asarray(f.tokens, np.int32)])
        if t.replays and f.status == "ok":
            self.stats["recovered_completions"] += 1
        return FinishedSeq(rid, tokens, int(tokens.shape[0]), t.prompt_len,
                           f.status)

    def _recover(self, cause: Optional[BaseException]) -> StepReport:
        """Rebuild the engine and resubmit every request in flight; runs
        no tick itself. The returned report's ``finished`` holds the
        requests whose deadline passed while the engine was down."""
        if self.stats["restarts"] >= self.cfg.serve.max_restarts:
            raise EngineRestartExhausted(
                f"engine crashed again after {self.stats['restarts']} "
                f"restarts (serve.max_restarts="
                f"{self.cfg.serve.max_restarts}); giving up with "
                f"{len(self._tracked)} requests in flight") from cause
        self.stats["restarts"] += 1
        for k, v in self._eng.stats.items():
            self._stats_acc[k] = self._stats_acc.get(k, 0) + v
        if self.params_path is not None:
            # a re-read through the integrity check: a damaged artifact
            # fails the recovery loudly
            self.params = self._load(self.params_path)
            self.stats["params_reloads"] += 1
        self._sup_of.clear()
        self._eng_of.clear()
        self._eng = self._make_engine()
        now = self.clock()
        finished: List[FinishedSeq] = []
        for t in sorted(self._tracked.values(), key=lambda x: x.rid):
            if t.deadline <= now:
                # expired during the outage: the supervisor finishes it
                self._stats_acc["timeout_evictions"] = \
                    self._stats_acc.get("timeout_evictions", 0) + 1
                self._tracked.pop(t.rid)
                base = np.asarray(t.emitted, np.int32)
                finished.append(FinishedSeq(t.rid, base, int(base.shape[0]),
                                            t.prompt_len, "timeout"))
                continue
            batch = dict(t.batch)
            if t.emitted:
                prefix = torch.tensor([t.emitted],
                                      dtype=batch["tokens"].dtype)
                batch["tokens"] = torch.cat([batch["tokens"], prefix], dim=1)
            t.replay_base = list(t.emitted)
            t.replays += 1
            mnt = t.max_new - len(t.emitted)
            if mnt <= 0:    # every token emitted, the finish not reported
                self._tracked.pop(t.rid)
                toks = np.asarray(t.emitted, np.int32)
                self.stats["recovered_completions"] += 1
                finished.append(FinishedSeq(t.rid, toks, int(toks.shape[0]),
                                            t.prompt_len, "ok"))
                continue
            rem = t.deadline - now if np.isfinite(t.deadline) else 0.0
            eng_rid = self._eng.submit(batch, max_new_tokens=mnt,
                                       eos_id=t.eos_id, timeout_s=rem,
                                       force=True)
            self._sup_of[eng_rid] = t.rid
            self._eng_of[t.rid] = eng_rid
            self.stats["replayed_requests"] += 1
        return StepReport([], None, [], [], finished, self._eng.active,
                          self._eng.lanes)

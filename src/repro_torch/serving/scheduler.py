"""Continuous batching: the twin of the JAX package's
``serving/scheduler.py``.

``ContinuousEngine`` keeps a fixed batch of ``serve.max_batch`` decode
lanes over a slotted cache (``models.transformer.cache_slots_like`` /
``cache_slot_insert``) and admits and evicts sequences mid-flight:

- **submit** queues a batch-1 request with its own budget, eos and
  deadline; a full admission queue (``serve.max_queue``) raises
  :class:`QueueFullError`.
- **step** is one tick: a deadline sweep (on an injectable clock), parked
  requests into free lanes, deficit-driven prefill (chunks of
  ``serve.prefill_chunk`` positions keep running while a lane would
  otherwise sit empty, one chunk a tick once supply covers the lanes),
  then one decode step over every lane.

A prefill runs at batch 1 through ``engine.prefill_begin`` /
``prefill_step`` / ``prefill_finish``; its first token is picked from the
prefill logits and its cache is written into a free lane, the whole lane
overwritten, so a lane freed by an eviction needs no zeroing.

The greedy tick is ``engine.decode_step_guarded`` over the slotted cache
and the ``(lanes,)`` token and position buffers. On the card the first
tick runs eagerly (kernel builds, library handles, workspaces), the
second captures it into one CUDA graph (``ops.CapturedCall``) and every
tick replays it: the slotted cache is created at the first insert and
never rebound, and insert, poison and the buffers' refills write into the
captured tensors in place. Each tick reads back the ``(lanes,)`` tokens
and finite-logits flags. On the CPU the same step runs as a plain call.
Every op of the step is row-wise in the lane axis, so a lane's numerics
do not depend on the other lanes, and greedy tokens are those of the
static ``engine.generate`` on each sequence wherever the kernels' shapes
agree (``w4a16_matmul`` picks its tiles by the row count). At
temperature > 0 the tick runs eagerly and each request draws from its own
``torch.Generator`` seeded from ``(seed, rid)``: not the static engine's
stream, as in the JAX package.

Failure handling, as in the JAX package: requests past their deadline are
evicted with status ``timeout`` wherever they are; the
``serve.decode_step`` site poisons the first occupied lane's cache (NaN in
its float leaves) and the finite-logits flags quarantine that lane only
(``decode_nan_guard``); a ``serve.prefill_chunk`` fault drops only its own
request (``error``); ``serve.engine_step`` fires before a tick mutates
anything, and any exception that leaves :meth:`step` (a kernel fault at
``kernels.pallas_dispatch`` among them: there is no degraded route) is the
supervisor's to recover (serving/supervisor.py). ``stats`` counts every
eviction and rejection; ``kernel_degradations`` stays 0.

EOS convention (as in ``engine.generate``): eos itself is never emitted;
``FinishedSeq.tokens`` holds exactly ``steps`` usable tokens.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.config import Config
from repro_torch.core import faults
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E

Tensor = torch.Tensor


class QueueFullError(RuntimeError):
    """:meth:`ContinuousEngine.submit` at ``serve.max_queue`` waiting
    requests: an explicit rejection instead of an unbounded queue."""


class FinishedSeq(NamedTuple):
    rid: int
    tokens: np.ndarray      # (steps,) generated ids, eos excluded
    steps: int              # == len(tokens)
    prompt_len: int         # decoder prompt positions (frontend included)
    status: str = "ok"      # ok | timeout | quarantined | cancelled | error


class _Pending(NamedTuple):
    rid: int
    batch: Dict[str, Any]
    max_new: int
    eos_id: int
    deadline: float = float("inf")   # absolute clock() time


def _poison_lane(caches: List[Dict], lane: int) -> None:
    """The ``serve.decode_step`` payload: NaN into every float leaf of one
    lane of the slotted cache, in place (the lane axis is each leaf's
    first). Its next decode logits go non-finite; no other lane is
    touched."""
    for leaf in T.cache_leaves(caches):
        if leaf.is_floating_point():
            leaf[lane].fill_(float("nan"))


class _Prefill:
    """A request mid-prefill: its embedded inputs, batch-1 caches, cursor."""

    def __init__(self, req: _Pending, h: Tensor, caches: List[Dict]):
        self.req = req
        self.h = h
        self.caches = caches
        self.start = 0
        self.h_last: Optional[Tensor] = None
        self.first: Optional[int] = None    # first token, set at completion

    @property
    def done(self) -> bool:
        return self.start >= self.h.shape[1]


class StepReport(NamedTuple):
    admitted: List[int]         # rids that began prefill this tick
    prefill_rid: Optional[int]  # rid that ran a prefill chunk this tick
    first_tokens: List[tuple]   # (rid, token) picked from prefill logits
    decoded: List[tuple]        # (rid, token) decode-step emissions
    finished: List[FinishedSeq]
    active: int                 # occupied decode lanes after this tick
    lanes: int


def _request_seed(seed: int, rid: int) -> int:
    """The seed of request ``rid``'s sampling generator."""
    return int(np.random.SeedSequence([seed, rid]).generate_state(1)[0])


class ContinuousEngine:
    """Slot-based continuous batching over a fixed batch of decode lanes.

    Runs on the CUDA card unless ``device="cpu"``; ``params`` must live
    there already."""

    def __init__(self, cfg: Config, params: Any, *,
                 max_len: Optional[int] = None, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 device: Union[str, torch.device, None] = None):
        self.dev = resolve_device(device)
        have = E._params_device(params)
        if have.type != self.dev.type:
            raise ValueError(f"params live on {have}, the engine was asked "
                             f"to run on {self.dev}")
        self.dev = have
        self.cfg = cfg
        self.params = params
        self.lanes = cfg.serve.max_batch
        self.cap = max_len or cfg.model.max_seq_len
        self.seed = seed
        # deadlines run off an injectable clock, so tests and benchmarks
        # drive timeouts on a virtual time axis
        self.clock = clock or time.monotonic
        self._next_rid = 0
        self._queue: deque = deque()
        self._prefill: Optional[_Prefill] = None
        self._ready: deque = deque()        # prefilled, waiting for a lane
        self._caches: Optional[List[Dict]] = None   # the slotted cache
        # the host's lane table
        self._lane_rid = np.full((self.lanes,), -1, np.int64)
        self._token = np.zeros((self.lanes,), np.int64)
        self._pos = np.zeros((self.lanes,), np.int64)
        self._remaining = np.zeros((self.lanes,), np.int64)
        self._eos = np.full((self.lanes,), -1, np.int64)
        self._deadline = np.full((self.lanes,), np.inf)
        self._out: Dict[int, List[int]] = {}
        self._prompt_len: Dict[int, int] = {}
        self._nstep: Dict[int, int] = {}
        self._gens: Dict[int, torch.Generator] = {}
        # the tick's device buffers and its graph (created with the cache)
        self._tok_dev: Optional[Tensor] = None
        self._pos_dev: Optional[Tensor] = None
        self._graph: Optional[ops.CapturedCall] = None
        self._warm = False
        self.capture_s = 0.0
        self.stats: Dict[str, int] = {
            "timeout_evictions": 0, "rejections": 0, "cancelled": 0,
            "quarantined": 0, "kernel_degradations": 0,
            "prefill_failures": 0,
        }

    def engine_stats(self) -> Dict[str, Any]:
        """The failure counters (the port has no kernel backend to
        report: a kernel fault raises)."""
        return dict(self.stats)

    # -- submission --------------------------------------------------------

    def submit(self, batch: Dict[str, Any], *,
               max_new_tokens: Optional[int] = None, eos_id: int = -1,
               timeout_s: Optional[float] = None,
               force: bool = False) -> int:
        """Queue one request: ``batch`` is batch-1 ``{"tokens", "embeds"?
        | "frames"?}`` (tensors or arrays). Raises :class:`QueueFullError`
        (counted in ``stats["rejections"]``) when ``serve.max_queue`` > 0
        requests already wait. ``timeout_s`` (default
        ``serve.request_timeout_s``; 0 = no deadline) starts now, so queue
        wait counts. ``force`` bypasses the queue bound: the supervisor
        resubmits requests that were already admitted before a crash."""
        batch = {k: v if isinstance(v, Tensor) else torch.from_numpy(
            np.array(v)) for k, v in batch.items() if v is not None}
        if batch["tokens"].shape[0] != 1:
            raise ValueError("submit one sequence at a time")
        max_queue = self.cfg.serve.max_queue
        if not force and max_queue > 0 and len(self._queue) >= max_queue:
            self.stats["rejections"] += 1
            raise QueueFullError(
                f"admission queue full ({len(self._queue)} >= {max_queue})")
        mnt = max_new_tokens or self.cfg.serve.max_new_tokens
        n_front = batch["embeds"].shape[1] if "embeds" in batch else 0
        need = batch["tokens"].shape[1] + n_front + mnt + 1
        if need > self.cap:
            raise ValueError(f"request needs {need} positions, "
                             f"cap={self.cap}")
        tmo = self.cfg.serve.request_timeout_s if timeout_s is None \
            else timeout_s
        deadline = self.clock() + tmo if tmo and tmo > 0 else float("inf")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Pending(rid, batch, mnt, eos_id, deadline))
        return rid

    def cancel(self, rid: int) -> Optional[FinishedSeq]:
        """Cancel a request wherever it is (queued, mid-prefill, parked,
        decoding): a partial :class:`FinishedSeq` with status
        ``"cancelled"``, or None if ``rid`` is not in flight."""
        for q in (self._queue, self._ready):
            for item in list(q):
                item_rid = item.rid if isinstance(item, _Pending) \
                    else item.req.rid
                if item_rid == rid:
                    q.remove(item)
                    self.stats["cancelled"] += 1
                    return self._finish_rid(rid, "cancelled")
        if self._prefill is not None and self._prefill.req.rid == rid:
            self._prefill = None
            self.stats["cancelled"] += 1
            return self._finish_rid(rid, "cancelled")
        lanes = np.nonzero(self._lane_rid == rid)[0]
        if lanes.size:
            self._evict(int(lanes[0]))
            self.stats["cancelled"] += 1
            return self._finish_rid(rid, "cancelled")
        return None

    # -- scheduling --------------------------------------------------------

    @property
    def active(self) -> int:
        return int((self._lane_rid >= 0).sum())

    @property
    def idle(self) -> bool:
        return (not self._queue and self._prefill is None
                and not self._ready and self.active == 0)

    def step(self) -> StepReport:
        """One tick: prefill chunks and one decode step over the lanes. The
        ``serve.engine_step`` site fires before anything changes."""
        faults.fire("serve.engine_step")
        with torch.no_grad():
            return self._step()

    def run(self) -> Dict[int, FinishedSeq]:
        """Tick until every submitted request has finished."""
        done: Dict[int, FinishedSeq] = {}
        while not self.idle:
            for f in self.step().finished:
                done[f.rid] = f
        return done

    def _sweep_deadlines(self, finished: List[FinishedSeq]) -> None:
        """Evict every request past its deadline, wherever it is."""
        now = self.clock()
        for req in [r for r in self._queue if r.deadline < now]:
            self._queue.remove(req)
            self.stats["timeout_evictions"] += 1
            finished.append(self._finish_rid(req.rid, "timeout"))
        if self._prefill is not None and self._prefill.req.deadline < now:
            self.stats["timeout_evictions"] += 1
            finished.append(self._finish_rid(self._prefill.req.rid,
                                             "timeout"))
            self._prefill = None
        for pf in [p for p in self._ready if p.req.deadline < now]:
            self._ready.remove(pf)
            self.stats["timeout_evictions"] += 1
            finished.append(self._finish_rid(pf.req.rid, "timeout"))
        for i in np.nonzero((self._lane_rid >= 0)
                            & (self._deadline < now))[0]:
            rid = int(self._lane_rid[i])
            self._evict(int(i))
            self.stats["timeout_evictions"] += 1
            finished.append(self._finish_rid(rid, "timeout"))

    def _step(self) -> StepReport:
        admitted: List[int] = []
        first_tokens: List[tuple] = []
        finished: List[FinishedSeq] = []
        prefill_rid = None

        self._sweep_deadlines(finished)
        while self._ready and self.active < self.lanes:
            self._insert(self._ready.popleft())
        if self._prefill is None and self._queue:
            admitted.append(self._admit())

        # deficit-driven prefill: chunks keep running while the next tick
        # would leave a lane empty; once supply covers every lane, one
        # chunk a tick bounds what a decode tick waits for
        ran_chunk = False
        while self._prefill is not None:
            pf = self._prefill
            starved = self.active + len(self._ready) < self.lanes
            if ran_chunk and not starved and self.active > 0:
                break
            chunk = self.cfg.serve.prefill_chunk or pf.h.shape[1]
            c0 = pf.start
            c1 = min(pf.h.shape[1], c0 + chunk)
            try:
                faults.fire("serve.prefill_chunk")
                pf.h_last, pf.caches = E.prefill_step(
                    self.cfg, self.params, pf.h[:, c0:c1], c0, pf.caches)
            except faults.FaultError as e:
                if e.site != "serve.prefill_chunk":
                    raise
                # a failed prefill drops only its own request
                self.stats["prefill_failures"] += 1
                finished.append(self._finish_rid(pf.req.rid, "error"))
                self._prefill = None
                if self._queue:
                    admitted.append(self._admit())
                continue
            pf.start = c1
            ran_chunk = True
            prefill_rid = pf.req.rid
            if pf.done:
                first_tokens.extend(self._complete_prefill(pf, finished))
                self._prefill = None
                if self._queue:
                    admitted.append(self._admit())

        decoded = self._decode_tick(finished) if self.active else []
        return StepReport(admitted, prefill_rid, first_tokens, decoded,
                          finished, self.active, self.lanes)

    # -- internals ---------------------------------------------------------

    def _admit(self) -> int:
        req = self._queue.popleft()
        inputs = {k: v.to(self.dev) for k, v in req.batch.items()}
        h, caches = E.prefill_begin(self.cfg, self.params, inputs, self.cap)
        self._prefill = _Prefill(req, h, caches)
        self._prompt_len[req.rid] = h.shape[1]
        return req.rid

    def _gen(self, rid: int) -> torch.Generator:
        gen = self._gens.get(rid)
        if gen is None:
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(_request_seed(self.seed, rid))
            self._gens[rid] = gen
        return gen

    def _pick(self, rid: int, logits: Tensor) -> Tensor:
        temp = self.cfg.serve.temperature
        return E._sample(logits, temp, self._gen(rid) if temp > 0 else None)

    def _complete_prefill(self, pf: _Prefill, finished: List[FinishedSeq]
                          ) -> List[tuple]:
        req = pf.req
        logits = E.prefill_finish(self.cfg, self.params, pf.h_last)
        first = int(self._pick(req.rid, logits)[0])
        if first == req.eos_id:            # eos on the very first pick
            self._gens.pop(req.rid, None)
            finished.append(FinishedSeq(req.rid, np.zeros((0,), np.int32), 0,
                                        self._prompt_len.pop(req.rid, 0)))
            return []
        self._out[req.rid] = [first]
        self._nstep[req.rid] = 1
        if req.max_new <= 1:
            finished.append(self._finish_rid(req.rid))
            return [(req.rid, first)]
        pf.first = first
        if self.active < self.lanes:
            self._insert(pf)
        else:
            self._ready.append(pf)
        return [(req.rid, first)]

    def _insert(self, pf: _Prefill) -> None:
        req = pf.req
        lane = int(np.nonzero(self._lane_rid < 0)[0][0])
        if self._caches is None:
            self._caches = T.cache_slots_like(pf.caches, self.lanes)
            self._tok_dev = torch.zeros(self.lanes, dtype=torch.long,
                                        device=self.dev)
            self._pos_dev = torch.zeros(self.lanes, dtype=torch.long,
                                        device=self.dev)
        T.cache_slot_insert(self._caches, pf.caches, lane)
        self._lane_rid[lane] = req.rid
        self._token[lane] = pf.first
        self._pos[lane] = self._prompt_len[req.rid]
        self._remaining[lane] = req.max_new - 1
        self._eos[lane] = req.eos_id
        self._deadline[lane] = req.deadline

    def _finish_rid(self, rid: int, status: str = "ok") -> FinishedSeq:
        self._gens.pop(rid, None)
        toks = np.asarray(self._out.pop(rid, []), np.int32)
        return FinishedSeq(rid, toks, self._nstep.pop(rid, 0),
                           self._prompt_len.pop(rid, 0), status)

    def _guarded_step(self):
        return E.decode_step_guarded(self.cfg, self.params, self._tok_dev,
                                     self._pos_dev, self._caches)[:2]

    def _greedy_tick(self):
        """(next tokens, finite flags) of every lane: eager on the CPU and
        at the card's first tick, then the captured graph's replay."""
        if self.dev.type != "cuda" or not self._warm:
            self._warm = True
            return self._guarded_step()
        if self._graph is None:
            t = time.perf_counter()
            self._graph = ops.CapturedCall(self._guarded_step)
            self.capture_s = time.perf_counter() - t
        self._graph.replay()
        return self._graph.out

    def _decode_tick(self, finished: List[FinishedSeq]) -> List[tuple]:
        temp = self.cfg.serve.temperature
        decoded: List[tuple] = []
        # the serve.decode_step fault poisons the first occupied lane's
        # cache before the step; the step's own finite flags detect it
        if faults.poll("serve.decode_step") is not None:
            _poison_lane(self._caches,
                         int(np.nonzero(self._lane_rid >= 0)[0][0]))
        self._tok_dev.copy_(torch.from_numpy(self._token))
        self._pos_dev.copy_(torch.from_numpy(self._pos))
        if temp <= 0.0:
            nxt, ok = self._greedy_tick()
            raw, ok = nxt.cpu().numpy(), ok.cpu().numpy()
        else:
            logits, _ = E.serve_step(self.cfg, self.params, self._tok_dev,
                                     self._pos_dev, self._caches)
            ok = torch.isfinite(logits).all(dim=-1).cpu().numpy()
            raw = np.zeros((self.lanes,), np.int64)
            for i in np.nonzero(self._lane_rid >= 0)[0]:
                raw[i] = int(self._pick(int(self._lane_rid[i]),
                                        logits[i:i + 1])[0])
        nan_guard = self.cfg.serve.decode_nan_guard
        for i in np.nonzero(self._lane_rid >= 0)[0]:
            rid = int(self._lane_rid[i])
            if nan_guard and not ok[i]:
                # quarantine: evict the poisoned lane only; the next insert
                # overwrites it wholesale
                self._evict(int(i))
                self.stats["quarantined"] += 1
                finished.append(self._finish_rid(rid, "quarantined"))
                continue
            tok = int(raw[i])
            if tok == self._eos[i]:
                self._evict(int(i))
                finished.append(self._finish_rid(rid))
                continue
            self._out[rid].append(tok)
            self._nstep[rid] += 1
            decoded.append((rid, tok))
            self._token[i] = tok
            self._pos[i] += 1
            self._remaining[i] -= 1
            if self._remaining[i] == 0:
                self._evict(int(i))
                finished.append(self._finish_rid(rid))
        return decoded

    def _evict(self, lane: int) -> None:
        # the host's table only: an insert overwrites the whole lane
        self._lane_rid[lane] = -1
        self._token[lane] = 0
        self._pos[lane] = 0
        self._remaining[lane] = 0
        self._eos[lane] = -1
        self._deadline[lane] = np.inf

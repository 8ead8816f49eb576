"""Deterministic fault-injection plane, the port's copy of the JAX
package's ``core/faults.py``.

Each failure mode the robustness paths handle (a non-PSD or NaN Hessian,
a NaN decode lane, a kernel dispatch that fails, an engine tick dying
under a live queue, a damaged checkpoint) is a *named site*
(``FAULT_SITES``, the same names as the JAX package's, so one
``faults.arm`` string arms either package) that tests and launchers arm
with a *seeded trigger schedule*:

    site@N          the N-th hit fires (1-based)
    site@A..B       hits A to B fire
    site@N+         hit N and every later one fire
    site@pX         every hit fires with probability X

with an optional ``:mode`` suffix (``kill`` by default; a corruption
site reads it as its payload, e.g. ``hessian.cholesky@1:nan``). A
probabilistic schedule draws from a numpy generator seeded with
``(seed & 0xFFFFFFFF) ^ crc32(site)``, as the JAX package's does, so the
same arming fires at the same hits in both packages.

Hot code calls :func:`fire` (raises :class:`FaultError` when the schedule
fires) or :func:`poll` (returns the :class:`FaultSpec` where the fault is
a corruption the call site applies itself). Both are host Python: a site
counts a hit where the code that holds it runs on the host. On the card
that is an eager call or the capture of a CUDA graph, never a replay (a
replay runs the captured launches without passing the host code), as in
the JAX package a site fires when a function is traced, not when its
compiled form runs. Tests use :func:`inject`; launchers call
:func:`install_from_config` (the ``faults.arm=...`` override).
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Dict, Iterator, Optional

import numpy as np

FAULT_SITES = (
    "hessian.cholesky",
    "plan.stage1_executor",
    "plan.stage2_executor",
    "stream.capture_forward",
    "serve.decode_step",
    "serve.prefill_chunk",
    "serve.engine_step",
    "kernels.pallas_dispatch",
    "checkpoint.load",
)


class FaultError(RuntimeError):
    """An injected kill-type fault; ``site`` names where it fired."""

    def __init__(self, site: str, mode: str, hit: int):
        super().__init__(f"injected fault at {site!r} "
                         f"(mode={mode}, hit {hit})")
        self.site = site
        self.mode = mode
        self.hit = hit


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site: a trigger window, a per-hit probability, a mode."""
    site: str
    mode: str = "kill"
    first: int = 1          # first hit (1-based) that may fire
    last: int = -1          # last hit that may fire; -1 = no end
    prob: float = 1.0       # per-hit fire probability inside the window


def parse_spec(text: str) -> FaultSpec:
    """Parse one ``site@trigger[:mode]`` spec (grammar in the module doc)."""
    text = text.strip()
    if "@" not in text:
        raise ValueError(f"fault spec needs site@trigger, got {text!r}")
    site, rest = text.split("@", 1)
    site = site.strip()
    if site not in FAULT_SITES:
        raise ValueError(f"unknown fault site {site!r}; "
                         f"known: {', '.join(FAULT_SITES)}")
    mode = "kill"
    if ":" in rest:
        rest, mode = rest.split(":", 1)
    rest = rest.strip()
    if rest.startswith("p"):
        return FaultSpec(site, mode, first=1, last=-1, prob=float(rest[1:]))
    if rest.endswith("+"):
        return FaultSpec(site, mode, first=int(rest[:-1]), last=-1)
    if ".." in rest:
        a, b = rest.split("..", 1)
        return FaultSpec(site, mode, first=int(a), last=int(b))
    n = int(rest)
    return FaultSpec(site, mode, first=n, last=n)


class FaultPlane:
    """Armed specs, per-site hit counters and seeded probability streams."""

    def __init__(self):
        self._specs: Dict[str, FaultSpec] = {}
        self._rng: Dict[str, np.random.Generator] = {}
        self.hits: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def arm(self, spec, seed: int = 0) -> FaultSpec:
        if isinstance(spec, str):
            spec = parse_spec(spec)
        if spec.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {spec.site!r}")
        self._specs[spec.site] = spec
        # the schedule is a function of (seed, site) alone
        self._rng[spec.site] = np.random.default_rng(
            (seed & 0xFFFFFFFF) ^ zlib.crc32(spec.site.encode()))
        self.hits[spec.site] = 0
        self.fired[spec.site] = 0
        return spec

    def arm_string(self, text: str, seed: int = 0) -> None:
        """Arm a comma-separated spec list (the ``faults.arm`` value)."""
        for part in text.split(","):
            if part.strip():
                self.arm(part, seed=seed)

    def disarm(self, site: Optional[str] = None) -> None:
        if site is None:
            self._specs.clear()
            self._rng.clear()
        else:
            self._specs.pop(site, None)
            self._rng.pop(site, None)

    def armed(self, site: str) -> bool:
        return site in self._specs

    def poll(self, site: str) -> Optional[FaultSpec]:
        """Count a hit; return the spec when the schedule fires at it."""
        spec = self._specs.get(site)
        if spec is None:
            return None
        self.hits[site] = h = self.hits.get(site, 0) + 1
        if h < spec.first or (spec.last >= 0 and h > spec.last):
            return None
        if spec.prob < 1.0 and self._rng[site].random() >= spec.prob:
            return None
        self.fired[site] = self.fired.get(site, 0) + 1
        return spec

    def fire(self, site: str) -> None:
        """Kill-type site: raise :class:`FaultError` when the schedule
        fires."""
        spec = self.poll(site)
        if spec is not None:
            raise FaultError(site, spec.mode, self.hits[site])

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"hits": dict(self.hits), "fired": dict(self.fired)}


#: the process-wide plane every site consults
PLANE = FaultPlane()


def fire(site: str) -> None:
    PLANE.fire(site)


def poll(site: str) -> Optional[FaultSpec]:
    return PLANE.poll(site)


def armed(site: str) -> bool:
    return PLANE.armed(site)


@contextlib.contextmanager
def inject(*specs, seed: int = 0) -> Iterator[FaultPlane]:
    """Arm specs for a ``with`` block; the previous arming comes back on
    exit, also when the injected fault propagates out."""
    parsed = [parse_spec(s) if isinstance(s, str) else s for s in specs]
    saved = {p.site: PLANE._specs.get(p.site) for p in parsed}
    try:
        for p in parsed:
            PLANE.arm(p, seed=seed)
        yield PLANE
    finally:
        for site, prev in saved.items():
            if prev is None:
                PLANE.disarm(site)
            else:
                PLANE.arm(prev, seed=seed)


def install_from_config(cfg) -> None:
    """Arm the plane from ``cfg.faults`` (the launchers call this)."""
    fc = getattr(cfg, "faults", None)
    if fc is not None and fc.arm:
        PLANE.arm_string(fc.arm, seed=fc.seed)

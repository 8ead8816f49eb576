"""Meshes of ranks: :func:`make_host_mesh` (sharded training's
``launch.train --mesh d,m``), the ``quant.mesh`` knob → a ``DeviceMesh``
for sharded group execution (:func:`make_quant_mesh`), and the production
meshes of the shape-only dry run (:func:`make_production_mesh` inside
:func:`fake_world`).

The twin of the JAX package's ``launch/mesh.py``. The JAX package's
mesh is devices of one process; the port's is ranks, one process each,
on ``torch.distributed``:

- under ``torch.distributed.run`` (``RANK`` / ``WORLD_SIZE`` set) and
  without a process group yet, :func:`init_from_env` starts one. Its
  backend follows from the facts it prints: gloo on the CPU; NCCL when
  every rank on the host has a card of its own; gloo when ranks share a
  card, which NCCL refuses. A failing backend raises: nothing falls back
  to another backend or to the CPU;
- a caller that set up its own group (a test's ``file://`` rendezvous)
  keeps it;
- each rank's card is ``cuda:{LOCAL_RANK % device_count}``
  (``device.resolve_device``);
- the dry run (``launch/dryrun.py``) stands in for one rank of a 256- or
  512-rank world: :func:`fake_world` opens a process group on the
  ``fake`` backend (its collectives move nothing) and destroys it on
  exit.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.quantize --arch opt-proxy --smoke \\
        --device cpu quant.mesh=2x2
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def choose_backend(device: Union[str, torch.device]) -> tuple:
    """``(backend, why)`` for ranks on ``device`` under torchrun."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", f"{local} ranks on this host, {cards} cards: one each"
    return "gloo", (f"{local} ranks on this host share {cards} card"
                    f"{'s' if cards != 1 else ''}, which NCCL refuses")


def init_from_env(device: Union[str, torch.device]) -> bool:
    """Start the process group of a torchrun world; False when there is
    none to start (no ``RANK`` / ``WORLD_SIZE``, a world of one, or a
    group already set up by the caller)."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    backend, why = choose_backend(device)
    dist.init_process_group(backend)
    if dist.get_rank() == 0:
        print(f"[mesh] process group: {backend}, {dist.get_world_size()} "
              f"ranks ({why})", flush=True)
    return True


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   expert: int = 1,
                   device: Union[str, torch.device] = "cpu"):
    """A ``DeviceMesh`` over the first pod·data·model(·expert) ranks with
    the JAX package's dim names: ``("data", "model")``, with ``pod > 1``
    ``("pod", "data", "model")``, with ``expert > 1`` ``("data", "model",
    "expert")`` (the expert axis does not compose with ``pod``: ValueError,
    as in JAX). Every rank of the world calls it (the dims' process groups
    are made collectively), ranks past the mesh too. The groups over a
    product of dims are made here as well: ``("pod", "data")``, training's
    data parallel axes, and, with both ``expert`` and ``data`` above 1,
    ``("expert", "data")`` (an expert-stacked group's lanes)."""
    from torch.distributed.device_mesh import DeviceMesh
    if expert > 1 and pod > 1:
        raise ValueError("expert axis does not compose with pod axis")
    if expert > 1:
        shape, names = (data, model, expert), ("data", "model", "expert")
    elif pod > 1:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    n = 1
    for s in shape:
        n *= s
    mesh = DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=names)
    if expert > 1 and data > 1:
        sharding.build_axis_groups(mesh, ("expert", "data"))
    if pod > 1:
        sharding.build_axis_groups(mesh, ("pod", "data"))
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production meshes (``src/repro/launch/mesh.py:23``)
    as ranks: 16 x 16 over ``("data", "model")``, or with ``multi_pod``
    2 x 16 x 16 over ``("pod", "data", "model")``. The world must hold 256
    or 512 ranks (:func:`fake_world` for the dry run)."""
    if multi_pod:
        return make_host_mesh(pod=2, data=16, model=16)
    return make_host_mesh(data=16, model=16)


@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """A process group of ``world`` ranks on torch's ``fake`` backend, this
    process its rank 0, for the shape-only dry run: collectives return at
    once and move nothing. The group and every axis group made under it
    are destroyed on exit, so nothing is left behind for a later group in
    the process (a test worker's next module). Refuses to run inside a
    live process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    before = set(sharding._AXIS_GROUPS)
    try:
        yield
    finally:
        for key in set(sharding._AXIS_GROUPS) - before:
            del sharding._AXIS_GROUPS[key]
        dist.destroy_process_group()


def make_quant_mesh(spec: str = "off",
                    device: Union[str, torch.device] = "cpu"
                    ) -> Optional[object]:
    """``quant.mesh`` knob → DeviceMesh for sharded group execution.

    - "off" (default) / "" / "none" / "1x1" → None: single-device
      execution;
    - "auto" → every rank of the world on the ``data`` axis;
    - "DxM" (e.g. "2x2") → (data, model) over the first D·M ranks;
    - "DxMxE" (e.g. "1x2x2") → adds the ``expert`` axis: groups made
      entirely of stacked expert slabs shard lanes over expert (×data).

    Under torchrun the world's process group is started first
    (:func:`init_from_env`). A malformed spec, or one that needs more
    ranks than the world has, prints the JAX package's line and returns
    None, as there."""
    def _fallback(why: str):
        if rank() == 0:
            print(f"[mesh] quant.mesh={spec!r} {why} — falling back to "
                  f"single-device execution")
        return None

    if not spec or spec in ("off", "none", "1", "1x1", "1x1x1"):
        return None
    init_from_env(device)
    if spec == "auto":
        n = world_size()
        if n <= 1:
            return None
        return make_host_mesh(data=n, model=1, device=device)
    parts = spec.lower().split("x")
    if len(parts) not in (2, 3):
        return _fallback("is not 'off', 'auto', 'DxM' or 'DxMxE'")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        return _fallback("is not 'off', 'auto', 'DxM' or 'DxMxE'")
    if any(s < 1 for s in sizes):
        return _fallback("has non-positive axis sizes")
    d, m = sizes[0], sizes[1]
    e = sizes[2] if len(sizes) == 3 else 1
    total = d * m * e
    if total <= 1:
        return None
    if world_size() < total:
        return _fallback(f"needs {total} devices, have {world_size()}")
    return make_host_mesh(data=d, model=m, expert=e, device=device)


def mesh_sizes(mesh) -> dict:
    """``{dim name: size}``, as the launcher prints it."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))

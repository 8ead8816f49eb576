"""What one step of a dry-run cell costs a rank, counted on fake tensors:
the twin of the JAX package's ``src/repro/launch/hlo_analysis.py`` and
``hlo_text.py``, which read FLOPs, bytes and collectives from compiled
HLO, which torch has none of.

:class:`CostCounter` runs over one step under :func:`fake_mode`:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas (its
  registry, read in the one dispatch mode: a second mode cost a third of
  a pass's wall) for the aten ops, plus each hand-written kernel's own
  count from its fake calls
  (``kernels/ops.fake_log``, the work of ``kernels/work.py``);
- bytes: each aten op's input and output bytes (views move none), the
  traffic of an eager, unfused step, plus the kernels' own bytes;
- collectives: by kind, with calls and bytes, from the port's wrappers
  (``distributed/sharding.comm_by_kind``);
- the high-water of live bytes: each new storage an op makes adds its
  bytes, and a weakref finalizer takes them off when the last tensor on
  it dies; the step's arguments (registered first) are counted apart, as
  ``memory_analysis()`` splits arguments from temporaries.

:func:`cost_terms` keeps the JAX artifact's keys where the meaning carries
over, against one NVIDIA H100 80GB HBM3 at 700 W (``kernels/work.py``).
:func:`active_param_count`, :func:`total_param_count` and
:func:`model_flops_estimate` are the JAX package's
(``hlo_analysis.py:230-296``) on the port's ``layer_specs``.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.work import H100_BF16_FLOPS, H100_BYTES, H100_NVLINK
from repro_torch.models import transformer as T

# the card's device memory as its name states it (NVIDIA H100 80GB HBM3:
# 80·10⁹ bytes, under the ~85·10⁹ the card reports), what ``fits_80gb``
# holds a rank's peak against
H100_MEMORY = 80 * 10 ** 9


def fake_device() -> str:
    """The device the dry run's fake tensors claim: the card's where torch
    has one. A torch without CUDA cannot take a fake CUDA tensor's
    in-place copies (``copy_``, ``contiguous``: its Python bindings guard
    the device), so there they claim the CPU; the kernel wrappers route a
    fake tensor by its fakeness, so the kernels' calls are the same."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_mode() -> Iterator[FakeTensorMode]:
    """A ``FakeTensorMode`` for a dry run; a tensor made inside it that
    outlives it stays fake. Module-level caches of tensors that a fake pass
    could fill (whisper's position table) are emptied on exit."""
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    try:
        with mode:
            yield mode
    finally:
        T._position_table.cache_clear()


def _tensors(tree, objects: bool = False) -> Iterator[torch.Tensor]:
    """The tensors of a tree; ``objects``: inside plain objects too (a
    ``QuantizedTensor``'s)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v, objects)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v, objects)
    elif objects and hasattr(tree, "__dict__"):
        for v in vars(tree).values():
            yield from _tensors(v, objects)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counting(TorchDispatchMode):
    """Bytes of every op and the live storages (module docstring)."""

    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.c
        c.ops += 1
        if func.namespace in ("c10d", "_c10d_functional"):
            return out                  # counted as collectives
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            c.flops += flop(*args, **kwargs, out_val=out)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not func.is_view:
            c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        in_keys = {_key(t) for t in ins}
        for t in outs:
            c._track(t, new=not func.is_view and _key(t) not in in_keys)
        return out


class CostCounter:
    """Counts one step: ``with CostCounter(args) as cc: step(...)``, under
    :func:`fake_mode`. ``args``: the trees the step runs on, registered
    as arguments (their storages never count as temporaries)."""

    def __init__(self, args: Any = None):
        self.ops = 0
        self.bytes = 0
        self.arg_keys = set()
        self.arg_bytes = 0
        for t in _tensors(args, objects=True):
            k = _key(t)
            if k not in self.arg_keys:
                self.arg_keys.add(k)
                self.arg_bytes += t.untyped_storage().nbytes()
        self.live: Dict[int, list] = {}
        self.temp = 0
        self.peak_temp = 0
        self.flops = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.kernel_log: list = []
        self.collectives: Dict[str, Dict[str, float]] = {}

    def _track(self, t: torch.Tensor, new: bool) -> None:
        k = _key(t)
        if k in self.arg_keys:
            return
        ent = self.live.get(k)
        if ent is None:
            if not new:
                return          # a view of a storage made before the step
            ent = self.live[k] = [t.untyped_storage().nbytes(), 0]
            self.temp += ent[0]
            self.peak_temp = max(self.peak_temp, self.temp)
        ent[1] += 1
        weakref.finalize(t, self._release, k)

    def _release(self, k: int) -> None:
        ent = self.live.get(k)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.temp -= ent[0]
            del self.live[k]

    def __enter__(self) -> "CostCounter":
        ops.reset_fake_calls()
        sharding.reset_comm_bytes()
        self._mode = _Counting(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        self.kernels = ops.fake_calls()
        self.kernel_log = ops.fake_log()
        self.kernel_flops = sum(w.flop for _, _, w in self.kernel_log)
        self.kernel_bytes = sum(w.nbytes for _, _, w in self.kernel_log)
        self.collectives = sharding.comm_by_kind()

    def memory_analysis(self) -> Dict[str, int]:
        """``memory_analysis()``'s split: arguments, the temporaries'
        high-water, what is still live at the end (the outputs), and
        their peak sum, in bytes."""
        return {"argument_size_in_bytes": self.arg_bytes,
                "temp_size_in_bytes": self.peak_temp,
                "output_size_in_bytes": self.temp,
                "peak_memory_in_bytes": self.arg_bytes + self.peak_temp}


def cost_terms(cc: CostCounter, n_devices: int,
               model_flops: float = 0.0) -> Dict[str, Any]:
    """The three roofline terms of one rank's step (FLOPs at the bf16
    tensor-core rate, bytes at HBM's, collective link bytes at NVLink's)
    and their inputs, under the JAX artifact's keys."""
    flops = float(cc.flops + cc.kernel_flops)
    nbytes = float(cc.bytes + cc.kernel_bytes)
    link = sum(v["link_bytes"] for v in cc.collectives.values())
    t_compute = flops / H100_BF16_FLOPS
    t_memory = nbytes / H100_BYTES
    t_collective = link / H100_NVLINK
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])[0]
    mem = cc.memory_analysis()
    out = {
        "per_device_flops": flops,
        "per_device_bytes": nbytes,
        "aten_flops": float(cc.flops), "aten_bytes": float(cc.bytes),
        "aten_ops": cc.ops,
        "kernel_calls": cc.kernels,
        "kernel_flops": cc.kernel_flops, "kernel_bytes": cc.kernel_bytes,
        "collectives": {
            "counts": {k: v["count"] for k, v in cc.collectives.items()},
            "bytes": {k: v["bytes"] for k, v in cc.collectives.items()},
            "link_bytes_per_rank": link},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "memory_analysis": mem,
        "fits_80gb": mem["peak_memory_in_bytes"] <= H100_MEMORY,
        "n_devices": n_devices,
    }
    if model_flops > 0:
        total = flops * n_devices
        out["model_flops"] = model_flops
        out["useful_fraction"] = model_flops / total if total else 0.0
        bound = max(t_compute, t_memory, t_collective)
        out["roofline_fraction"] = (
            (model_flops / n_devices / H100_BF16_FLOPS) / bound
            if bound else 0.0)
    return out


# -- the JAX package's parameter and model-FLOP counts -----------------------

def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for train;
    2·N(_active) per generated token for decode; 2·N·D for prefill."""
    n_active = active_param_count(cfg.model)
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def active_param_count(mc) -> float:
    """Parameters touched per token (MoE counts top-k + shared experts)."""
    d, v = mc.d_model, mc.vocab_size
    h, kv, hd = mc.num_heads, mc.num_kv_heads, mc.head_dim
    total = v * d * (1 if mc.tie_embeddings else 2)
    for mixer, mlp_kind in T.layer_specs(mc):
        if mixer == "mla":
            m = mc.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            total += (d * m.q_lora_rank + m.q_lora_rank * h * qk
                      + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                      + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                              + m.v_head_dim)
                      + h * m.v_head_dim * d)
        elif mixer in ("attn", "swa", "local"):
            total += d * (h + 2 * kv) * hd + h * hd * d
        elif mixer == "rglru":
            w = mc.rglru.lru_width
            total += d * w * 2 + w * w * 2 + w * d + w * mc.rglru.conv1d_width
        elif mixer == "mamba":
            di = mc.ssm.expand * d
            total += (d * 2 * di + di * mc.ssm.d_conv
                      + di * (mc.ssm.dt_rank + 2 * mc.ssm.d_state)
                      + mc.ssm.dt_rank * di + di * d)
        if mlp_kind == "dense":
            total += (3 if mc.gated_mlp else 2) * d * mc.d_ff
        elif mlp_kind == "moe":
            m = mc.moe
            total += 3 * d * m.d_ff_expert * (m.top_k + m.num_shared_experts)
            total += d * m.num_experts          # router
    if mc.is_encoder_decoder:
        # encoder layers + decoder cross-attention
        total += mc.encoder_layers * (d * (h + 2 * kv) * hd + h * hd * d
                                      + 2 * d * mc.d_ff)
        total += mc.num_layers * (d * (h + 2 * kv) * hd + h * hd * d)
    return float(total)


def total_param_count(mc) -> float:
    """All parameters (MoE counts every expert)."""
    total = active_param_count(mc)
    for _, mlp_kind in T.layer_specs(mc):
        if mlp_kind == "moe":
            m = mc.moe
            total += 3 * mc.d_model * m.d_ff_expert * (m.num_experts
                                                       - m.top_k)
    return float(total)

"""Configuration dataclasses for the PyTorch port.

The port's own copy of the fields its decoder-only quantize → pack → serve
path reads, with the same names and defaults as the JAX package's
configuration, plus the dotted ``key=value`` override helpers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

# the layer kinds the port runs; the JAX package's others (swa, local,
# rglru, mla) wait in ROADMAP.md's port queue
PORTED_KINDS = ("attn", "mamba")


@dataclass
class SSMConfig:
    """Mamba-1 block configuration, read by the "mamba" layers."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model/16)


@dataclass
class ModelConfig:
    name: str = "tiny"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4           # GQA: num_heads % num_kv_heads == 0
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 512
    # block kinds ("attn" | "mamba"), cycled over the layer stack
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu (gated) | gelu (ungated)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"         # compute dtype
    ssm: SSMConfig = field(default_factory=SSMConfig)

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.num_heads
        if "mamba" in self.layer_kinds and self.ssm.dt_rank == 0:
            self.ssm.dt_rank = max(1, -(-self.d_model // 16))
        bad = sorted(set(self.block_pattern) - set(PORTED_KINDS))
        if bad:
            raise ValueError(
                f"block kinds {bad} are not ported to repro_torch yet "
                f"(ported: {list(PORTED_KINDS)}); see ROADMAP.md, queue 1 "
                "'Modules to port'")

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))


@dataclass
class QuantConfig:
    bits: int = 4
    group_size: int = 128
    symmetric: bool = False
    percdamp: float = 0.01
    blocksize: int = 128            # GPTQ lazy-update block
    rpiq_iters: int = 5
    rpiq_alpha: float = 0.01
    rpiq_early_stop: bool = True
    rpiq_use_global_hessian: bool = True   # eq. 12-14: block-diag of damped H


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    kv_cache: str = "fp16"          # fp16 (the bf16 cache) | int8: decode
    #                                 KV-cache precision; "int8" stores
    #                                 per-block absmax codes + f32 scales
    #                                 (kernels/kv_codec.py) with per-lane
    #                                 error feedback on decode appends


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def apply_overrides(cfg: Any, overrides: Dict[str, str]) -> Any:
    """Apply dotted-path overrides to a (nested) dataclass, in place."""
    for key, value in overrides.items():
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key: {key}")
        setattr(obj, leaf, _coerce(value, getattr(obj, leaf))
                if isinstance(value, str) else value)
    return cfg


def parse_overrides(argv: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k] = v
    return out

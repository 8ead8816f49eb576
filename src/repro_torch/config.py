"""Configuration dataclasses for the PyTorch port.

The port's own copy of the fields its quantize → pack → serve paths
(decoder-only and encoder-decoder), its training and its launchers read,
with the
same names and defaults as the JAX package's configuration, plus the
dotted ``key=value`` override helpers. ``quant.mesh`` shards the
quantization executor over a ``torch.distributed`` world
(``launch/mesh.py``). A value the port does not run
(``quant.batched_executor=false``,
``quant.gptq_impl=xla`` / ``quant.rpiq_impl=xla``) is accepted here and
raises where it would be used, naming its ROADMAP.md item.
``model.opt_attention=false`` runs the reference's naive attention
baseline (models/attention.py). ``quant.pipeline`` takes both of the
JAX package's schedules, ``serial`` and ``overlap`` (core/stream.py);
``quant.jit_capture`` and ``quant.moe_flip_budget`` are read by the
overlap schedule alone. ``quant.act_order``, ``quant.keep_best_projection``
and ``serve.quantized`` are taken with the JAX package's defaults and read
nowhere, as there; so are ``serve.w4a16_impl`` and ``serve.kv_impl``:
the port has one route per device and no kernel backend to choose (a
kernel fault raises, it does not degrade). Every ``train.*`` field is
taken (training, ``repro_torch.training``); every ``parallel.*`` field
is taken (:class:`ParallelConfig` says which are read);
``parallel.sp=true`` runs in sharded training on every architecture: the
``model`` axis splits each layer kind (dense attention and MLPs, GQA,
MLA, Mamba, RG-LRU, routed experts, the MTP head) or gathers the
sequence whole for it.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Tuple

# the layer kinds the port runs ("swa" and "local" are windowed attention
# on a ring cache; an attention kind runs MLA when ``mla.enabled``)
PORTED_KINDS = ("attn", "swa", "local", "rglru", "mamba")


@dataclass
class MLAConfig:
    """Multi-head latent attention (deepseek-v3), read by the attention
    layers when ``enabled``."""
    enabled: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass
class SSMConfig:
    """Mamba-1 block configuration, read by the "mamba" layers."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model/16)
    d_inner: int = 0                # 0 => expand * d_model (the port's
    #                                 own field: a sharded step's rank
    #                                 runs d_inner / m channels)


@dataclass
class RGLRUConfig:
    """RG-LRU recurrent block (recurrentgemma), read by the "rglru"
    layers."""
    enabled: bool = False
    lru_width: int = 0              # 0 => d_model
    conv1d_width: int = 4


@dataclass
class MoEConfig:
    """Routed mixture of experts (the "moe" MLP of every layer from
    ``first_dense_layers`` on; ``num_experts`` 0 = dense)."""
    num_experts: int = 0            # 0 => dense
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    num_shared_experts: int = 0     # deepseek-style always-on experts
    first_dense_layers: int = 0     # leading layers that stay dense
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    router_dtype: str = "float32"


@dataclass
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4           # GQA: num_heads % num_kv_heads == 0
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 512
    max_seq_len: int = 8192
    # block kinds ("attn" | "swa" | "local" | "rglru" | "mamba"), cycled
    # over the layer stack
    block_pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 0            # swa/local attention window (0 = full)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu (gated) | gelu (ungated)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True           # False: no rotary embedding (whisper's
    #                                 fixed sinusoidal positions instead)
    tie_embeddings: bool = False    # the head is embedding.T (no lm_head)
    logits_softcap: float = 0.0     # tanh(logits / c) * c when > 0
    attn_logits_softcap: float = 0.0    # the same on attention scores
    dtype: str = "bfloat16"         # compute dtype
    param_dtype: str = "float32"    # master parameter dtype (training)
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    # encoder-decoder (whisper): a bidirectional encoder of encoder_layers
    # over encoder_seq_len precomputed frames, read by the decoder's
    # cross-attention
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500     # frames after the (stubbed) conv frontend
    # modality frontend stub: "none" | "vision" | "audio"; its
    # frontend_tokens precomputed embeddings are prepended at prefill
    frontend: str = "none"
    frontend_tokens: int = 0
    # multi-token prediction (deepseek): an "mtp" subtree when > 0
    # (transformer.mtp_logits), its CE weighted by mtp_loss_weight in the
    # training loss
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # False selects the JAX package's naive fp32 attention baseline
    # (models/attention.py)
    opt_attention: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.num_heads
        if "mamba" in self.layer_kinds and self.ssm.dt_rank == 0:
            self.ssm.dt_rank = max(1, -(-self.d_model // 16))
        if self.rglru.enabled and self.rglru.lru_width == 0:
            self.rglru.lru_width = self.d_model
        bad = sorted(set(self.block_pattern) - set(PORTED_KINDS))
        if bad:
            raise ValueError(f"unknown block kinds {bad} (the port runs "
                             f"{list(PORTED_KINDS)})")

    @property
    def d_inner(self) -> int:
        """A Mamba layer's channels: ``ssm.d_inner`` where set, else
        ``expand · d_model``."""
        return self.ssm.d_inner or self.ssm.expand * self.d_model

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def is_subquadratic(self) -> bool:
        """True if the arch decodes unbounded contexts on bounded state
        (windowed attention, RG-LRU, Mamba), as in the JAX package."""
        return set(self.layer_kinds) <= {"swa", "local", "rglru", "mamba"}


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
    keep_best_projection: bool = True   # read nowhere (nor in JAX)
    calib_batches: int = 8
    calib_batch_size: int = 16
    calib_seq_len: int = 512
    act_order: bool = False         # read nowhere (nor in JAX)
    gptq_impl: str = "auto"         # auto | pallas: the stages' one route
    rpiq_impl: str = "auto"         # (the kernel on the card); xla, the
    #                                 JAX package's plain route, is not
    #                                 ported (ROADMAP.md queue 1 item 9)
    jit_capture: bool = True        # the port compiles no capture forward;
    #                                 the key only governs speculation:
    #                                 false blocks the overlap schedule's
    #                                 capture-ahead (fallback_eager_capture),
    #                                 as eager capture does in JAX
    batched_executor: bool = True   # false selects the JAX package's
    #                                 per-linear baseline: not ported
    #                                 (ROADMAP.md queue 1 item 9)
    mesh: str = "off"               # sharded group execution: off | auto
    #                                 | DxM | DxMxE over the ranks of a
    #                                 torch.distributed world
    #                                 (launch/mesh.make_quant_mesh)
    resume: str = "off"             # off | auto: with "auto" and a ckpt_dir,
    #                                 quantize_model restarts a killed walk
    #                                 at the first incomplete LayerStep;
    #                                 the artifacts are bitwise those of an
    #                                 uninterrupted run
    ckpt_dir: str = ""              # "" = no step checkpoints; else the
    #                                 walk's streams and stored layers are
    #                                 saved there at every step boundary
    ckpt_keep: int = 2              # retained step checkpoints in ckpt_dir
    pipeline: str = "serial"        # layer-walk schedule (core/stream.py):
    #                                 serial | overlap (the next layer's
    #                                 capture runs ahead on a side CUDA
    #                                 stream); bitwise the same artifacts
    moe_flip_budget: float = 0.5    # overlap + routed MoE: the largest
    #                                 share of (token, k) assignments that
    #                                 may flip between the speculative and
    #                                 the true stream before the layer's
    #                                 speculative plans are all discarded
    #                                 (fallback_flip_budget)
    guardrail: bool = True          # the stage-1 guardrail ladder
    #                                 (core/plan.py): lanes with non-finite
    #                                 stage-1 output get damping retries, then
    #                                 the group's RTN lane; counted in
    #                                 QuantReport.guardrail_stats
    guardrail_retries: int = 2      # damping-escalation rungs before RTN
    guardrail_damp_factor: float = 10.0  # percdamp multiplier per rung


@dataclass
class ParallelConfig:
    """The JAX package's parallelism fields. Training reads ``remat`` and
    ``int8_optimizer_state``; sharded training (``train(mesh=…)``) reads
    ``fsdp`` (the placement), ``ep_local_dispatch`` (the routed MoE) and
    ``sp`` (the residual's sequence over ``model``). The mesh
    comes from ``--mesh`` /
    ``make_host_mesh``: ``data``, ``model``, ``pod``, ``ep``,
    ``pipeline_stages``, ``pp_microbatches``, ``scan_layers``,
    ``overlap_collectives`` and ``grad_compression`` are taken and read
    nowhere, as in the reference."""
    data: int = 1
    model: int = 1
    pod: int = 1
    fsdp: bool = True
    sp: bool = False
    ep: bool = True
    pipeline_stages: int = 1
    pp_microbatches: int = 8
    remat: str = "full"             # none | full | dots: "full" and "dots"
    #                                 both recompute each superblock in the
    #                                 backward (torch.utils.checkpoint), as
    #                                 the reference's one jax.checkpoint
    scan_layers: bool = True
    grad_compression: str = "none"
    int8_optimizer_state: bool = False  # AdamW moments as int8 blocks of
    #                                     128 with f32 absmax scales
    overlap_collectives: bool = True
    ep_local_dispatch: bool = True


@dataclass
class TrainConfig:
    global_batch_size: int = 8
    seq_len: int = 128
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"        # cosine | wsd | constant
    wsd_stable_frac: float = 0.8
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 200
    ckpt_dir: str = "/tmp/repro_ckpt"   # the trainer's step checkpoints;
    #                                     the quantize launcher starts from
    #                                     the parameters of the latest one
    ckpt_keep: int = 3
    ckpt_async: bool = True


@dataclass
class ServeConfig:
    max_batch: int = 8              # decode lanes of the continuous engine
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    quantized: bool = True          # read nowhere (nor in JAX)
    prefill_chunk: int = 0          # 0 = single-shot prefill; > 0 = prefill
    #                                 in chunks of this many positions
    #                                 (logits and caches those of the
    #                                 single-shot prefill)
    scheduler: str = "static"       # static = engine.generate; continuous =
    #                                 serving/scheduler.ContinuousEngine
    w4a16_impl: str = "auto"        # read nowhere: the port has no kernel
    kv_impl: str = "auto"           # backend to choose (module docstring)
    kv_cache: str = "fp16"          # fp16 (the bf16 cache) | int8: decode
    #                                 KV-cache precision; "int8" stores
    #                                 per-block absmax codes + f32 scales
    #                                 (kernels/kv_codec.py) with per-lane
    #                                 error feedback on decode appends
    request_timeout_s: float = 0.0  # per-request deadline (0 = none)
    max_queue: int = 0              # admission queue bound (0 = unbounded):
    #                                 a submit beyond it raises QueueFullError
    decode_nan_guard: bool = True   # quarantine a lane whose decode logits
    #                                 go non-finite (evict that lane only)
    supervise: bool = False         # wrap the continuous engine in
    #                                 serving/supervisor.SupervisedEngine
    step_timeout_s: float = 0.0     # the supervisor's watchdog (0 = off)
    max_restarts: int = 3           # engine rebuilds before
    #                                 EngineRestartExhausted


@dataclass
class FaultsConfig:
    """The fault-injection plane's arming (core/faults.py)."""
    arm: str = ""                   # comma-separated "site@trigger[:mode]"
    #                                 specs, e.g. "hessian.cholesky@1:nan"
    seed: int = 0                   # seed of the probabilistic (@pX) specs


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    faults: FaultsConfig = field(default_factory=FaultsConfig)


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error for a configuration value the port does not run yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, queue 1 "
        f"item {item}")


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


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(x) for x in cfg]
    return cfg

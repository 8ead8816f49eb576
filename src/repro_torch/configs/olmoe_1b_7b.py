"""olmoe-1b-7b — a routed mixture of experts: 64 experts, top 8, 1B active
of 7B parameters.

Full: 16 layers, d_model 2048, 16 heads (kv 16), per-expert d_ff 1024,
vocab 50304, RMSNorm, gated SiLU experts, every layer's MLP routed
[arXiv:2409.02060]. Smoke: 2 layers, d_model 64, 4 heads, 8 experts, top
2, d_ff_expert 64, vocab 128, quant group and blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig, MoEConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        norm="rmsnorm", act="silu", gated_mlp=True,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
        max_seq_len=32768 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="olmoe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=128,
        norm="rmsnorm", act="silu", gated_mlp=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
        max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

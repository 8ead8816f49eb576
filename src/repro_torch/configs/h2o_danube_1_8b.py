"""h2o-danube-1.8b — a dense GQA decoder with sliding-window attention.

Full: 24 layers, d_model 2560, 32 heads over 8 KV heads (head_dim 80),
d_ff 6912, vocab 32000, RMSNorm, gated SiLU MLP, every layer "swa" with a
4096-token window [arXiv:2401.16818]: decode keeps a ring cache of
min(window, max_len) slots, so its memory stays bounded over a long
session. Smoke: 2 layers, d_model 64, 4 heads over 2 KV heads, d_ff 160,
vocab 128, window 8, quant group and blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="h2o-danube-1.8b",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000,
        block_pattern=("swa",), window_size=4096,
        norm="rmsnorm", act="silu", gated_mlp=True,
        max_seq_len=524288 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="h2o-danube-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=128,
        block_pattern=("swa",), window_size=8,
        norm="rmsnorm", act="silu", gated_mlp=True, max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

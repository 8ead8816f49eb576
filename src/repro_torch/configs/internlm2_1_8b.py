"""internlm2-1.8b — a dense GQA decoder (16 heads over 8 KV heads).

Full: 24 layers, d_model 2048, 16 heads over 8 KV heads (head_dim 128),
d_ff 8192, vocab 92544, RMSNorm, gated SiLU MLP, no biases
[arXiv:2403.17297]. Smoke: 2 layers, d_model 64, 4 heads over 2 KV heads,
d_ff 192, vocab 128, quant group and blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="internlm2-1.8b",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        d_ff=8192, vocab_size=92544,
        norm="rmsnorm", act="silu", gated_mlp=True,
        max_seq_len=32768 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="internlm2-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=128,
        norm="rmsnorm", act="silu", gated_mlp=True,
        max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

"""opt-proxy — the paper's own evaluation family (OPT-style decoder LM).

Full: the OPT-125M shape (12 layers, d_model 768, 12 heads, d_ff 3072,
vocab 50304), LayerNorm, ungated GELU MLP, biases, RoPE positions.
Smoke: a 2-layer, d_model 64 same-family model for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="opt-proxy",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=50304,
        norm="layernorm", act="gelu", gated_mlp=False,
        max_seq_len=4096,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="opt-proxy-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256,
        norm="layernorm", act="gelu", gated_mlp=False,
        max_seq_len=64,
    )
    cfg.quant.group_size = 16
    cfg.quant.blocksize = 16
    return cfg

"""stablelm-1.6b — a dense decoder with LayerNorm and a gated SiLU MLP.

Full: 24 layers, d_model 2048, 32 heads (32 KV heads, head_dim 64), d_ff
5632, vocab 100352; LayerNorm with biases, so every dense carries a bias
too [hf:stabilityai/stablelm-2-1_6b]. Smoke: 2 layers, d_model 64, 4
heads, d_ff 160, vocab 128, quant group and blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="stablelm-1.6b",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        norm="layernorm", act="silu", gated_mlp=True,
        max_seq_len=32768 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="stablelm-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=128,
        norm="layernorm", act="silu", gated_mlp=True, max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

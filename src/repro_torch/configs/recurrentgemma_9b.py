"""recurrentgemma-9b — RG-LRU + local attention, 2 recurrent : 1.

Full: 38 layers, d_model 4096, 16 heads over 1 KV head (MQA), d_ff 12288
(gated GELU), vocab 256000 tied, local window 2048, lru_width 4096, conv
width 4, logits soft-capped at 30 [arXiv:2402.19427]. Bounded decode
state: each RG-LRU layer's h and conv inputs, each local layer's ring of
2048 slots. Smoke: 5 layers, d_model 64, window 8, quant group and
blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig, RGLRUConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000,
        block_pattern=("rglru", "rglru", "local"), window_size=2048,
        norm="rmsnorm", act="gelu", gated_mlp=True,
        rglru=RGLRUConfig(enabled=True, lru_width=4096, conv1d_width=4),
        logits_softcap=30.0, tie_embeddings=True,
        max_seq_len=524288 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=160, vocab_size=128,
        block_pattern=("rglru", "rglru", "local"), window_size=8,
        norm="rmsnorm", act="gelu", gated_mlp=True,
        rglru=RGLRUConfig(enabled=True, lru_width=64, conv1d_width=4),
        logits_softcap=30.0, tie_embeddings=True, max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

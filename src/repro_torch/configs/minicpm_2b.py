"""minicpm-2b — a dense decoder with tied input and output embeddings.

Full: 40 layers, d_model 2304, 36 heads (36 KV heads, head_dim 64), d_ff
5760, vocab 122753, RMSNorm, gated SiLU MLP; the head is the embedding
transposed, so the tree has no ``lm_head`` [arXiv:2404.06395]. Smoke: 2
layers, d_model 72, 6 heads (head_dim 12), d_ff 160, vocab 128, quant
group and blocksize 8, for CPU tests. Both train with the WSD schedule
(``train.schedule``), as in the JAX config.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="minicpm-2b",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        norm="rmsnorm", act="silu", gated_mlp=True,
        tie_embeddings=True, max_seq_len=32768 + 8,
    )
    cfg.train.schedule = "wsd"
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="minicpm-smoke",
        num_layers=2, d_model=72, num_heads=6, num_kv_heads=6,
        d_ff=160, vocab_size=128,
        norm="rmsnorm", act="silu", gated_mlp=True,
        tie_embeddings=True, max_seq_len=64,
    )
    cfg.train.schedule = "wsd"
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

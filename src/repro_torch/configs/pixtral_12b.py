"""pixtral-12b — the vision-language model: a Mistral-Nemo decoder that
reads precomputed patch embeddings before the text.

Full: 40 layers, d_model 5120, 32 heads over 8 KV heads with head_dim 128
(so q and o map 5120 ↔ 4096), d_ff 14336, vocab 131072, RMSNorm, gated
SiLU MLP [hf:mistralai/Pixtral-12B-2409]. The vision encoder is a stub:
a request carries ``embeds`` (B, 1024, 5120), prepended to the token
embeddings at prefill and in calibration. Smoke: 2 layers, d_model 64, 4
heads over 2 KV heads (head_dim 16), d_ff 160, vocab 128, 8 frontend
tokens, quant group and blocksize 8, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="pixtral-12b", family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        norm="rmsnorm", act="silu", gated_mlp=True,
        frontend="vision", frontend_tokens=1024,
        max_seq_len=32768 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="pixtral-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=128,
        norm="rmsnorm", act="silu", gated_mlp=True,
        frontend="vision", frontend_tokens=8, max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

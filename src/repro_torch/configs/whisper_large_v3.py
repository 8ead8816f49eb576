"""whisper-large-v3 — the audio model: an encoder-decoder whose decoder
reads the encoded speech through cross-attention [arXiv:2212.04356].

Full: 32 encoder + 32 decoder layers, d_model 1280, 20 heads over 20 KV
heads (head_dim 64), d_ff 5120, vocab 51866, LayerNorm, ungated GELU MLP,
no rotary embedding (``use_rope=False``), 1500 encoder frames. The JAX
config carries two stubs, kept here: the conv frontend (a request carries
precomputed ``frames`` (B, 1500, 1280) in its place), and fixed
sinusoidal positions in the decoder where the published model learns
them. Smoke: 2 + 2 layers, d_model 64, 4 heads, d_ff 128, vocab 128, 16
frames, quant group and blocksize 16, for CPU tests.
"""
from repro_torch.config import Config, ModelConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        norm="layernorm", act="gelu", gated_mlp=False, use_rope=False,
        is_encoder_decoder=True, encoder_layers=32, encoder_seq_len=1500,
        frontend="audio", frontend_tokens=1500,
        max_seq_len=32768 + 8,
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128,
        norm="layernorm", act="gelu", gated_mlp=False, use_rope=False,
        is_encoder_decoder=True, encoder_layers=2, encoder_seq_len=16,
        frontend="audio", frontend_tokens=16, max_seq_len=64,
    )
    cfg.quant.group_size = 16
    cfg.quant.blocksize = 16
    return cfg

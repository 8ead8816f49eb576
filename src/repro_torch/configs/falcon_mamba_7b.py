"""falcon-mamba-7b — pure Mamba-1, attention-free.

Full: 64 layers, d_model 4096 (d_inner 8192), d_state 16, d_conv 4,
dt_rank 256, vocab 65024, RMSNorm [arXiv:2410.05355]. As in the JAX
package's config, the mixer has no RMS norm on Δ, B and C (the published
FalconMamba applies one; ROADMAP.md records the difference). Smoke: 3
layers, d_model 64, d_state 8, vocab 128, quant group and blocksize 8, for
CPU tests.
"""
from repro_torch.config import Config, ModelConfig, SSMConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="falcon-mamba-7b",
        num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=65024,
        block_pattern=("mamba",),
        norm="rmsnorm",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    )
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="falcon-mamba-smoke",
        num_layers=3, d_model=64, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=128,
        block_pattern=("mamba",),
        norm="rmsnorm",
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

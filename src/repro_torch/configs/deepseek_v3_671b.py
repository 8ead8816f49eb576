"""deepseek-v3-671b — MLA + 1 shared + 256 routed experts top-8 + MTP.

Full: 61 layers, d_model 7168, 128 heads, per-expert d_ff 2048, vocab
129280, the first 3 layers dense (d_ff 18432), MLA ranks (q 1536 / kv 512,
nope 128 / rope 64 / v 128), one MTP depth [arXiv:2412.19437]. Smoke: 3
layers (1 dense), d_model 64, 8 experts top 2, MLA ranks 32 / 16, quant
group and blocksize 8, for CPU tests. Training keeps bf16 master weights,
int8 Adam moments and full remat, as the JAX config does.
"""
from repro_torch.config import Config, MLAConfig, ModelConfig, MoEConfig


def full() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        norm="rmsnorm", act="silu", gated_mlp=True,
        mla=MLAConfig(enabled=True, q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                      num_shared_experts=1, first_dense_layers=3),
        mtp_depth=1,
        param_dtype="bfloat16",
        max_seq_len=32768 + 8,
    )
    cfg.parallel.int8_optimizer_state = True
    cfg.parallel.remat = "full"
    return cfg


def smoke() -> Config:
    cfg = Config()
    cfg.model = ModelConfig(
        name="deepseek-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128,
        norm="rmsnorm", act="silu", gated_mlp=True,
        mla=MLAConfig(enabled=True, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1, first_dense_layers=1),
        mtp_depth=1, max_seq_len=64,
    )
    cfg.quant.group_size = 8
    cfg.quant.blocksize = 8
    return cfg

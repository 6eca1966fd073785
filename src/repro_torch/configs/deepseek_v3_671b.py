"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]"""

from .base import MLAConfig, ModelConfig, MoEConfig, register, smoke_of

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18_432,  # dense-prefix FFN width (paper: 18432 for first 3 layers)
    vocab_size=129_280,
    rope_theta=10_000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert_ff=2048,
        n_shared=1,
        d_shared_ff=2048,
        first_k_dense=3,
    ),
    mtp_depth=1,
)

register(
    CONFIG,
    smoke_of(
        CONFIG,
        n_heads=4,
        n_kv_heads=4,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64, n_shared=1,
                      d_shared_ff=64, first_k_dense=1),
        n_layers=3,
        mtp_depth=1,
    ),
)

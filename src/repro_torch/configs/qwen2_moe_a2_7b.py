"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from .base import ModelConfig, MoEConfig, register, smoke_of
from dataclasses import replace

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_expert_ff=1408,
        n_shared=4,
        d_shared_ff=1408,
    ),
)

register(
    CONFIG,
    smoke_of(
        CONFIG,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64, n_shared=2,
                      d_shared_ff=64),
    ),
)

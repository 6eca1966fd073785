"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; hf]"""

from .base import ModelConfig, SSMConfig, register, smoke_of

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    d_head=64,
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, variant="mamba2",
                  n_ssm_heads=64, chunk=128),
    attn_every=6,  # one shared attention block every 6 mamba layers
    sub_quadratic=True,
)

register(
    CONFIG,
    smoke_of(
        CONFIG,
        n_layers=4,
        attn_every=2,
        n_kv_heads=4,
        ssm=SSMConfig(state_dim=8, conv_dim=4, expand=2, variant="mamba2",
                      n_ssm_heads=4, chunk=16),
    ),
)

"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch.  [arXiv:2410.05355; unverified]"""

from .base import ModelConfig, SSMConfig, register, smoke_of

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # attention-free; kept for schema uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    d_head=64,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, variant="mamba1",
                  chunk=128),
    sub_quadratic=True,
)

register(
    CONFIG,
    smoke_of(
        CONFIG,
        d_ff=0,
        ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2, variant="mamba1",
                      chunk=16),
    ),
)

"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]"""

from .base import ModelConfig, register, smoke_of

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # multi-query attention
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
)

register(CONFIG, smoke_of(CONFIG, n_kv_heads=1))

"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008
vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]"""

from .base import ModelConfig, register, smoke_of

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11_008,
    vocab_size=102_400,
    rope_theta=10_000.0,
)

register(CONFIG, smoke_of(CONFIG, n_kv_heads=4))

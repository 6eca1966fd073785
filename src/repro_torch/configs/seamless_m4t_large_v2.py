"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal backbone; the audio frontend
is a stub (input_specs supplies precomputed frame embeddings).
[arXiv:2308.11596; hf]"""

from .base import ModelConfig, register, smoke_of

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,    # encoder layers over frame embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    rope_theta=10_000.0,
    frontend="audio",
)

register(CONFIG, smoke_of(CONFIG, n_encoder_layers=2))

"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution; the vision frontend is a stub
(input_specs supplies precomputed patch embeddings).
[arXiv:2409.12191; hf]"""

from .base import ModelConfig, register, smoke_of

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # (t, h, w) pairs; sum = d_head/2 = 64
    frontend="vision",
)

register(CONFIG, smoke_of(CONFIG, mrope_sections=(2, 3, 3)))

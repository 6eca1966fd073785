"""Model configuration schema + registry for the assigned architectures."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ModelConfig",
    "ShapeConfig",
    "register",
    "get_config",
    "list_configs",
    "SHAPES",
]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0  # leading dense layers (DeepSeek-V3 style)
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    variant: str = "mamba1"  # mamba1 | mamba2
    n_ssm_heads: int = 0     # mamba2 (SSD) heads; 0 = derive from expand*d/64
    chunk: int = 128         # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None  # (t, h, w) M-RoPE
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0  # hybrid: one shared attention block every k layers
    n_encoder_layers: int = 0  # encdec only
    mtp_depth: int = 0  # DeepSeek-V3 multi-token-prediction heads
    frontend: str | None = None  # 'audio' | 'vision' stub frontends
    attn_chunk: int = 1024  # chunked-attention query block
    sub_quadratic: bool = False  # may run long_500k
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        embed = v * d * (1 if self.tie_embeddings else 2)
        total = embed
        enc_layers = self.n_encoder_layers
        dec_layers = L

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                return (
                    d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank
                    * self.n_heads
                    * (m.qk_nope_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            return (
                d * self.n_heads * hd
                + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d
            )

        def mlp_params(ff):
            return 3 * d * ff

        def ssm_params():
            s = self.ssm
            d_in = s.expand * d
            return 2 * d * d_in + d_in * (2 * s.state_dim + s.conv_dim + 2) + d_in * d

        for _ in range(enc_layers):
            total += attn_params() + mlp_params(f) + 2 * d
        for i in range(dec_layers):
            if self.family in ("ssm",):
                total += ssm_params() + 2 * d
            elif self.family == "hybrid":
                total += ssm_params() + 2 * d
            elif self.moe is not None and i >= self.moe.first_k_dense:
                m = self.moe
                total += attn_params() + 2 * d
                total += m.n_experts * mlp_params(m.d_expert_ff)  # routed
                total += m.n_shared * mlp_params(m.d_shared_ff or m.d_expert_ff)
                total += d * m.n_experts  # router
            else:
                total += attn_params() + mlp_params(f) + 2 * d
            if self.family == "encdec":
                total += attn_params()  # cross-attention
        if self.family == "hybrid" and self.attn_every:
            total += attn_params()  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        routed_all = (
            (self.n_layers - m.first_k_dense) * m.n_experts * 3 * self.d_model * m.d_expert_ff
        )
        routed_active = (
            (self.n_layers - m.first_k_dense) * m.top_k * 3 * self.d_model * m.d_expert_ff
        )
        return int(full - routed_all + routed_active)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    from . import _load_all  # noqa: F401  (populates the registry)

    _load_all()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)


def smoke_of(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Derive a reduced smoke-test config of the same family."""
    defaults = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        d_head=16,
        attn_chunk=32,
    )
    defaults.update(overrides)
    if cfg.n_encoder_layers:
        defaults.setdefault("n_encoder_layers", 2)
    return replace(cfg, name=cfg.name + "-smoke", **defaults)

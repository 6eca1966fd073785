"""LM substrate: layers, attention (GQA/MLA), MoE, SSM, composition."""

from . import attention, layers, mla, model, moe, ssm, transformer

__all__ = ["attention", "layers", "mla", "model", "moe", "ssm", "transformer"]

"""LM substrate: layers, attention (GQA/MLA), MoE, SSM, composition."""

from . import attention, layers, mla, model, moe, sharding_policy, ssm, transformer

__all__ = ["attention", "layers", "mla", "model", "moe", "sharding_policy", "ssm",
           "transformer"]

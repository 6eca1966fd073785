"""Roofline analysis: per-device op costs + three-term roofline model."""

from .op_cost import OpCost, count_ops

__all__ = ["OpCost", "count_ops"]

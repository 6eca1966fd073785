"""Data substrate: deterministic token pipeline + KB linearisation."""

from .kb_corpus import KBTokenizer, linearise_materialisation
from .pipeline import DataConfig, SyntheticCorpus, TokenStream

__all__ = [
    "DataConfig",
    "KBTokenizer",
    "SyntheticCorpus",
    "TokenStream",
    "linearise_materialisation",
]

"""CompMat core on tensors: meta-facts, structure sharing via the
mu-mapping, compressed semi-naive evaluation (Algorithms 1-6), and the
flat reference engine; the frozen read side (``FrozenFacts``) that the
query package serves from.
"""

from .columns import ColumnStore, rle_encode
from .compile import JoinStep, Plan, PlanCache, ScanStep, compile_body
from .datalog import Atom, Program, Rule, parse_program, vertical_partition
from .engine import CMatEngine, MaterialisationStats
from .flat import FlatEngine, flat_seminaive
from .frozen import FrozenFacts, SortedRows
from .metafacts import FactStore, MetaFact, flat_repr_size
from .program_graph import explain_strata, is_recursive, stratify
from .terms import Dictionary

__all__ = [
    "Atom",
    "CMatEngine",
    "ColumnStore",
    "Dictionary",
    "FactStore",
    "FlatEngine",
    "FrozenFacts",
    "JoinStep",
    "MaterialisationStats",
    "MetaFact",
    "Plan",
    "PlanCache",
    "Program",
    "Rule",
    "ScanStep",
    "SortedRows",
    "compile_body",
    "explain_strata",
    "flat_repr_size",
    "flat_seminaive",
    "is_recursive",
    "parse_program",
    "rle_encode",
    "stratify",
    "vertical_partition",
]

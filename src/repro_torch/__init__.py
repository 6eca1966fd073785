"""The PyTorch/CUDA port of CompMat: datalog reasoning over compressed RDF
knowledge bases (Hu, Urbani, Motik, Horrocks — CIKM 2019) on an NVIDIA
H100.

Subpackages mirror the JAX package's layout: ``core`` (the paper's
engine on tensors, and ``FrozenFacts``, the frozen read side),
``query`` (conjunctive queries answered over the compressed store:
parser, planner, executor, ``QueryEngine``, micro-batches, the flat
oracle), ``kernels`` (hand-written CUDA kernels with their plain PyTorch
versions), ``obs`` (spans, metrics, byte reports), ``incremental`` (what
the distributed engine's ``apply`` needs), and the LLM substrate:
``configs`` (ten architectures), ``models`` (forward pass, loss and
KV/SSM-cache decode, rematerialised layers under autograd), ``optim``
(AdamW, schedules, int8 gradient compression), ``data`` (the token
pipeline and the KB linearisation) and ``train`` (train step,
checkpoints, fault tolerance).
:mod:`.convert` carries compressed state, parameters and train states
over from numpy arrays.
The entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

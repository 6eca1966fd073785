"""Runnable examples of the port, each the twin of one of the JAX
package's ``examples/``: :mod:`.quickstart` (the paper's running example
through ``CMatEngine``) and :mod:`.distributed_reasoning` (the
hash-partitioned engine, one shard per visible device) and
:mod:`.serve_decode` (a smoke model's prefill and greedy decode).

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.distributed_reasoning [--device cpu]
    python -m repro_torch.examples.serve_decode [--arch A] [--device cpu]
"""

"""Runnable examples of the port, each the twin of one of the JAX
package's ``examples/``: :mod:`.quickstart` (the paper's running example
through ``CMatEngine``) and :mod:`.distributed_reasoning` (the
hash-partitioned engine, one shard per visible device),
:mod:`.serve_decode` (a smoke model's prefill and greedy decode),
:mod:`.kb_train` (a model trained on the KB the engine materialises) and
:mod:`.elastic_restart` (failures injected and recovered from a
checkpoint, re-mesh planning, straggler detection) and :mod:`.query_kb`
(an ontology materialised and queried, a warm start, proof trees, MVCC
serving).

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.distributed_reasoning [--device cpu]
    python -m repro_torch.examples.serve_decode [--arch A] [--device cpu]
    python -m repro_torch.examples.kb_train [--steps N] [--device cpu]
    python -m repro_torch.examples.elastic_restart [--device cpu]
    python -m repro_torch.examples.query_kb [--device cpu]
"""

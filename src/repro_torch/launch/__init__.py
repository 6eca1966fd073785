"""Entry points: :mod:`.serve_datalog`, the query server (static
and ``--live``), and :mod:`.serve`, the model serving loop (prefill and
greedy decode).  ``python -m repro_torch.launch.serve_datalog --help``,
``python -m repro_torch.launch.serve --help``."""

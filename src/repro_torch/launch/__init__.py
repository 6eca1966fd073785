"""Entry points: :mod:`.serve_datalog`, the query server (static
and ``--live``), :mod:`.serve`, the model serving loop (prefill and
greedy decode), and :mod:`.train`, the training driver.  ``python -m
repro_torch.launch.serve_datalog --help``, ``python -m
repro_torch.launch.serve --help``, ``python -m repro_torch.launch.train
--help``."""

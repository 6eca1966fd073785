"""Entry points: :mod:`.serve_datalog`, the query server (static
and ``--live``).  ``python -m repro_torch.launch.serve_datalog --help``."""

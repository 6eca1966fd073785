"""The benchmark of the PyTorch/CUDA port (``repro_torch``): LUBM
materialisation on one card.  ``kbbench.run`` runs one cell;
``BENCHMARK.json`` lists the cells."""

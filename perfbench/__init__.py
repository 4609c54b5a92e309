"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port).

``run.py`` runs one cell of ``BENCHMARK.json``: a configuration from
``configs/``, a traffic mix from ``traffic/`` and the per-layer readers of
``metrics/``, each found by its name.  ``gen/`` makes the data and the
arrivals from the seed, ``ref/`` is the plain reference that decides
``correct``, and ``yard/`` holds the arithmetic of the metrics (interval
unions, launch counts, the FEE bytes, the card's peaks).  Nothing here
imports ``jax`` or the JAX package; only ``harness.py`` imports the port.
"""

"""The benchmark of ``photo_search_engine_tpu_torch`` on one NVIDIA H100.

One run of one cell: ``python3 -m portbench.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.  The cells,
configurations, traffic mixes and metrics are named in ``BENCHMARK.json``
at the root; each configuration, mix, request shape, judge kind, per-layer
metric and work count is a file of its own under this folder, found by its
name (``manifest.py``).
The yardstick lives here too: the corpus generator (``corpus.py``), the
plain reference that decides ``correct`` (``reference.py``, with each kind
of answer it judges by a file of its own under ``judges/``), the table of
peaks (``peaks.py``) and the reduction of a ``torch.profiler`` trace
(``trace.py``).  Nothing here imports JAX or the JAX package.
"""

"""The benchmark of ``gossipnet_tpu_torch`` on one NVIDIA card.

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Every cell, configuration, per-layer metric and kernel family is a file of
its own (``workloads/``, ``configs/``, ``metrics/``, ``kernels/``), found by
the name ``BENCHMARK.json`` gives it. Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""

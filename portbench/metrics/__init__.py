"""Per-layer metrics: one reader a file, ``<metric name>.py``, each with
its ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES`` and ``read(bench)``, which
returns the value or None when the run has nothing to read."""

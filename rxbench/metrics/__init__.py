"""Per-layer metrics, one reader module each, named as in
``BENCHMARK.json``: ``read(trace, cell) -> float | None`` takes the metric
from a :class:`rxbench.profiling.Trace` and returns ``None`` where it finds
nothing to read."""

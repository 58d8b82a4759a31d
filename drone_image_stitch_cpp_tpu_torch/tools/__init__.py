"""The port's benchmark harnesses: ``sortie_bench`` (render a sortie, run
the application on it, score the mosaic), ``bench_sortie`` (the 200-frame
flagship with the cold + warm-median protocol) and ``bench_throughput``
(the JAX repo's ``bench.py``: detect + match + RANSAC + 4K warp,
frames/s)."""

"""The port's sortie harness: ``sortie_bench`` (render a sortie, run the
application on it, score the mosaic) and ``bench_sortie`` (the 200-frame
flagship with the cold + warm-median protocol)."""

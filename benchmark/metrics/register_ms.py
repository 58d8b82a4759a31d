"""register_ms (ms): the pairs' kNN-2 ratio match and similarity RANSAC
of a batch (ops/match, ops/ransac), the harness's span around the call
with the card synchronised at both ends, the mean over the window's
batches."""


def read(ctx):
    vals = [u["register"] for u in ctx.units if "register" in u]
    return 1e3 * sum(vals) / len(vals) if vals else None

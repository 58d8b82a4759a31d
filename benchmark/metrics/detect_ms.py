"""detect_ms (ms): ops/features.detect_and_describe_batched of a batch
(scale space, extrema, K1), the harness's span around the call with the
card synchronised at both ends, the mean over the window's batches."""


def read(ctx):
    vals = [u["detect"] for u in ctx.units if "detect" in u]
    return 1e3 * sum(vals) / len(vals) if vals else None

"""batch_p95_ms (ms): the 95th percentile of every batch's latency in
the window (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile([u["seconds"] for u in ctx.units], 95))

"""idle_share.sortie (%): the share of one traced sortie's wall in which
no kernel, copy or memset ran on the card (the union of their intervals
from torch.profiler); read only from a trace that passed the in-trace
check and held a record of every launch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_ok:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.wall_s)

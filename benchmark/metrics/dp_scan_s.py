"""dp_scan_s (s): the strip stage's DP seams' row scans (the per-row
loop, the move table's fetch and the host backtrack), the program's dp
scan spans of every StripN stage (or Single) summed over a sortie, its
mean over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"dp scan done"})

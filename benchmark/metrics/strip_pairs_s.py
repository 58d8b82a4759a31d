"""strip_pairs_s (s): strip registration's match and RANSAC over the
pair schedule up to the fetch of the pair graph, the program's pairs
spans inside every StripN (or Single) register stage summed over a
sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"pairs done"})

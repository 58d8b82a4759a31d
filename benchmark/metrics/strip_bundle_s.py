"""strip_bundle_s (s): strip registration's float64 bundle adjust up to
the fetch of its transforms, the program's bundle adjust spans inside
every StripN (or Single) register stage summed over a sortie, its mean
over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"bundle adjust done"})

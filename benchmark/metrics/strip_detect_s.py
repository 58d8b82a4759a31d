"""strip_detect_s (s): strip registration's batched detect (gray, the
resize to the registration size, scale space, extrema, K1), the
program's detect spans inside every StripN (or Single) register stage
summed over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"detect done"})

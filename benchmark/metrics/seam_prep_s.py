"""seam_prep_s (s): the host work around the global graph cut's solves,
the program's [GlobalCustom] seam fetch (union boxes and masks to the
host, carved masks back), seam problem (the capacity grids and their
resizes) and seam band (the band dilation and the pinning) spans summed
over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean("GlobalCustom", {"seam fetch done",
                                          "seam problem done",
                                          "seam band done"})

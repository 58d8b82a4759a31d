"""strip_blend_s (s): the strip stage's multiband blend, the program's
blend and tiled blend records of every StripN stage (or Single) summed
over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"blend done",
                                              "tiled blend done"})

"""strip_seams_s (s): the DP seams of the strip stage, the program's
seams records of every StripN stage (or Single, for one line) summed
over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single", {"seams done"})

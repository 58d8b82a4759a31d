"""global_seams_s (s): the global stage's graph-cut seams, the program's
[GlobalCustom] seams record, a sortie's mean over the window."""


def read(ctx):
    return ctx.span_mean("GlobalCustom", {"seams done"})

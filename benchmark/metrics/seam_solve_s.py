"""seam_solve_s (s): the native min-cut solver's calls in the global
stage's graph-cut seams (coarse, fine and widened solves), the program's
[GlobalCustom] seam solve spans summed over a sortie, its mean over the
window."""


def read(ctx):
    return ctx.span_mean("GlobalCustom", {"seam solve done"})

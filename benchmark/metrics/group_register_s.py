"""group_register_s (s): grouping's match, RANSAC and the fetch of the
motion graph, the program's [VisualGroup] register+fetch records summed
over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean("VisualGroup", {"register+fetch done"})

"""group_detect_s (s): grouping's batched detect, the program's
[VisualGroup] detect records (the card synchronised at the end) summed
over a sortie, its mean over the window."""


def read(ctx):
    return ctx.span_mean("VisualGroup", {"detect done"})

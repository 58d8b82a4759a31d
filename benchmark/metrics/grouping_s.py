"""grouping_s (s): the program's [Main] grouping record (synchronised on
the card), a sortie's mean over the window."""


def read(ctx):
    return ctx.span_mean("Main", {"grouping done"})

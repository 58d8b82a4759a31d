"""global_blend_s (s): the global stage's tiled soft-mask blend, the
program's [GlobalCustom] blend record (the streamed mosaic's last
encoder wait included), a sortie's mean over the window."""


def read(ctx):
    return ctx.span_mean("GlobalCustom", {"blend done"})

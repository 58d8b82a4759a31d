"""blend_fetch_s (s): the tiled blends' host side of a tile's landing,
the program's tile fetch (a core's device-to-host copy and its unpack)
and rows out (a finished tile row handed to the streamed writer) spans of
the strip and global stages summed over a sortie, its mean over the
window."""


def read(ctx):
    return ctx.span_mean(r"Strip\d+|Single|GlobalCustom",
                         {"tile fetch done", "rows out done"})

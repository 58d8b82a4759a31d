"""io_wait_s (s): host I/O on the main thread's critical path, a sortie's
mean over the window: the [Main] strip-save drain (the writer thread's
strip JPEGs and checkpoint), the [Main] write (a mosaic written after the
blend) and the streamed mosaic's finish wait."""


def read(ctx):
    parts = [ctx.span_mean("Main", {"strip-save drain done", "write done"}),
             ctx.span_mean("GlobalCustom", {"streamed mosaic written"},
                           field="finish_wait_seconds")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None

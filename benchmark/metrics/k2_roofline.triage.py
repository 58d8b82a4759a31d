"""k2_roofline.triage (%): K2's single-plane form (csrc/warp_affine.cu)
over the traced batches: the time the card's published peaks allow for
what each launch was given (mosaicbench.work.k2_plane_bound: each
touched source pixel read once, each output pixel written once), over
the kernels' durations in the trace."""


def read(ctx):
    name = "warp_plane_kernel"
    if not (ctx.trace_ok and ctx.bounds and name in ctx.bounds):
        return None
    durs = ctx.trace.kernel_s(name)
    return 100.0 * ctx.bounds[name] / sum(durs) if durs else None

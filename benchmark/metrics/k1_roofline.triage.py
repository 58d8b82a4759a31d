"""k1_roofline.triage (%): K1 (csrc/sift_orient_desc.cu) over the traced
batches: the time the card's published peaks allow for what each call
was given (mosaicbench.work.k1_bound: the Gaussian stack and keypoints),
over the kernels' durations in the trace."""


def read(ctx):
    name = "sift_orient_desc_kernel"
    if not (ctx.trace_ok and ctx.bounds and name in ctx.bounds):
        return None
    durs = ctx.trace.kernel_s(name)
    return 100.0 * ctx.bounds[name] / sum(durs) if durs else None

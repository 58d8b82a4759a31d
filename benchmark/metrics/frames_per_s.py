"""frames_per_s (frames/s): frames in the batches the window completed,
over the window's length."""


def read(ctx):
    frames = int(ctx.config["frames"])
    return frames * len(ctx.units) / ctx.window_s

"""setup_s (s): the run's set-up, from the process's start to the
window's: Python and CUDA start, the program's kernel and host libraries
(built into the checkout's build/ by the first run there), the inputs
rendered from the seed and the warm-up."""


def read(ctx):
    return ctx.setup_s

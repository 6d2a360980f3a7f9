"""``setup_s``: process start to the window's start, on the host clock
(torch, the CUDA context, the kernel libraries, the inputs, the bind, the
group and the warm solves)."""


def read(run):
    return run.setup_s

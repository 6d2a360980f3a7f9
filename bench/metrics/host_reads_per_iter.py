"""``host_reads_per_iter``: the solvers' host reads per Krylov iteration
over the traced window: the window's ``host_reads`` over its
``iterations`` (the program's counters ``repro_torch.kernels.counters.
SOLVER``, as ``repro_torch.spans.window()`` reports their deltas).
Nothing to read where the program has no spans module or no window."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    if not w or not w["counters"]["iterations"]:
        return None
    c = w["counters"]
    return c["host_reads"] / c["iterations"]

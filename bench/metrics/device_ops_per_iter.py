"""``device_ops_per_iter``: device operations (kernels, copies, sets in
the profiler trace of the traced window) per Krylov iteration: the
trace's ``device_events`` over the window's ``iterations``
(``repro_torch.spans.window()``).  Nothing to read where the trace
holds no device activity (the CPU), or the program has no spans module
or no window."""


def read(run):
    t = run.trace
    if not t or not t["device_events"]:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    if not w or not w["counters"]["iterations"]:
        return None
    return t["device_events"] / w["counters"]["iterations"]

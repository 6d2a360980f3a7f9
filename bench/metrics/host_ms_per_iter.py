"""``host_ms_per_iter``: the host's own time in a Krylov iteration,
under the profiler: (host s of the ``krylov`` spans - host s of the
``host_read`` spans) / the window's iterations, in ms (the program's
spans, ``repro_torch.spans.window()``).  The host reads' waits are
left out: what remains is Python and launches.  Nothing to read where
the program has no spans module or no window."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    if not w or not w["counters"]["iterations"] or \
            "krylov" not in w["spans"]:
        return None
    rows = w["spans"]
    reads = rows["host_read"]["host_s"] if "host_read" in rows else 0.0
    return 1e3 * (rows["krylov"]["host_s"] - reads) / \
        w["counters"]["iterations"]

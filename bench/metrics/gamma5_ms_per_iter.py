"""``gamma5_ms_per_iter``: device time of the ``Dhat^dag``'s gamma5
copies per Krylov iteration: the device time of the ``gamma5`` spans
(CUDA events, the timed spans' sum scaled to all) over the window's
iterations, in ms
(``repro_torch.spans.window()``).  Nothing to read where no span timed
the device (the CPU), or the program has no spans module or no
window."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    row = w["spans"].get("gamma5") if w else None
    if not row or row["device_s"] is None or \
            not w["counters"]["iterations"]:
        return None
    return 1e3 * row["device_s"] / w["counters"]["iterations"]

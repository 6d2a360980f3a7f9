"""``dhat_solve_ms``: one ``Dhat`` inside the solve: the self device time
of the ``dhat`` spans (CUDA events around the ``Dhat`` and ``Dhat^dag``
the Krylov loop applies, their ``gamma5`` copies left out; the program
times one span in a few and scales the sum to all) over their count, in
ms (``repro_torch.spans.window()``).  Nothing to read where
no span timed the device (the CPU), or the program has no spans module
or no window."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    row = w["spans"].get("dhat") if w else None
    if not row or row["self_device_s"] is None or not row["count"]:
        return None
    return 1e3 * row["self_device_s"] / row["count"]

"""``fused_updates_per_iter``: the share of the window's Krylov iterations
whose update went through the fused CG update: the window's
``fused_updates`` over its ``iterations`` (the program's counters
``repro_torch.kernels.counters.SOLVER``, as ``repro_torch.spans.window()``
reports their deltas).  Nothing to read where the program has no spans
module, no window or no such counter."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = spans.window()
    if not w or not w["counters"].get("iterations"):
        return None
    c = w["counters"]
    if "fused_updates" not in c:
        return None
    return c["fused_updates"] / c["iterations"]

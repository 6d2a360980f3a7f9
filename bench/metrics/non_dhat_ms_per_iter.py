"""``non_dhat_ms_per_iter``: what an iteration costs beside its two
``Dhat`` applications: (solve time - 2 x iterations x one ``Dhat``) /
iterations, in ms.  Solve time and iterations are the means over the
window's solves (the profiler runs after the window); ``Dhat`` is the
CUDA-event time of the public operator after the window."""


def read(run):
    if run.dhat_s is None or not run.solve_s:
        return None
    it = sum(run.iterations) / len(run.iterations)
    if it <= 0:
        return None
    solve = sum(run.solve_s) / len(run.solve_s)
    return 1e3 * (solve - 2 * it * run.dhat_s) / it

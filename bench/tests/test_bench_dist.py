"""The multi-chip path of the harness rehearsed on the CPU: ranks over a
gloo group, rank 0's result, the reference over each rank's rows, and
``correct`` failing when the exchange between ranks is left out (each
rank wraps its own faces round instead of receiving its neighbours')."""
import multiprocessing as mp
import sys
import time

from bench_testutil import ROOT, add_cell, harness, tiny_root

WORLD = 2


def _rank(rank, rdv, cell, queue):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import halo
    device = torch.device("cpu")
    group = harness._init_group(rank, WORLD, rdv, device)
    try:
        outs = [harness.run_rank(cell, 2**31 + 21, 0.05, False, device,
                                 time.perf_counter(), rank, WORLD, group)]
        wrap = halo.extend_tz

        def local_faces(x, grid, t_axis=0, z_axis=1):
            return wrap(x, halo.TZGrid(), t_axis, z_axis)
        halo.extend_tz = local_faces
        outs.append(harness.run_rank(cell, 2**31 + 21, 0.05, False, device,
                                     time.perf_counter(), rank, WORLD,
                                     group))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put([harness.result(cell, o, False, device) for o in outs])


def test_ranks_agree_and_a_missing_exchange_is_caught(tmp_path):
    root = tiny_root(tmp_path)
    add_cell(root, "wilson-production.spin3.x2", "wilson-production",
             "spin3", chips=WORLD)
    cell = harness.load_cell("wilson-production.spin3.x2", root)
    cell.config["partition"]["t_ranks"] = WORLD
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    rdv = str(tmp_path / "rdv")
    procs = [ctx.Process(target=_rank, args=(r, rdv, cell, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        sound, broken = queue.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert sound["correct"], sound["checks"]
    assert sound["device"]["count"] == WORLD
    assert not broken["correct"]
    assert broken["checks"]["worst_residual"]["value"] > 1e-2

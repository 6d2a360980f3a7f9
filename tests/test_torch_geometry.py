"""The launch geometry of the kernels B1, B2 and B3
(``repro_torch.kernels.geometry``), checked on the CPU: the tiles cover
every (site, source, direction) once, the shared memory fits a block,
B1's blocks cover every (t-row, tile, source group) once with B2's
direction split, the tile routine's link copies (16 bytes or one real at
a time) land every link plane of a tile once, and B3's task list,
counters and ring are sized and ordered so that every consumer reads
what its producers wrote.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import random

import pytest

from repro_torch.kernels import geometry as geo
from repro_torch.kernels import wilson_stencil as ws

# (Z, Y, Xh): the main lattices' rows and ragged ones (Y*Xh and Z not
# multiples of the tile).
ROWS = [(16, 16, 8), (16, 16, 32), (5, 3, 3), (5, 3, 5), (7, 5, 3),
        (3, 4, 4)]
NRHS = [1, 2, 3, 5, 12, 13, 24]


def _directions(D, d):
    """The directions thread group ``d`` of ``D`` sums (hop_tile's
    direction groups)."""
    return [0, 1, 2, 3] if D == 1 else [[0, 1], [2, 3]][d]


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("nrhs", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tiles_cover_every_site_source_direction_once(row, nrhs, itemsize):
    """Blocks (tile, group) x threads (d, r, s), as hop_tile maps them,
    cover each (site, source, direction) of a t-row exactly once (f64
    splits the directions of one source)."""
    Z, Y, Xh = row
    g = geo.tile_geometry(Z, Y, Xh, nrhs, itemsize)
    row_sites = Z * Y * Xh
    seen = {}
    for grp in range(g.groups):
        r0 = grp * g.G
        nr = min(g.G, nrhs - r0)
        for tile in range(g.tiles):
            for tid in range(g.threads):
                d, r, s = (tid // (g.G * g.S), (tid // g.S) % g.G,
                           tid % g.S)
                site = tile * g.S + s
                if site >= row_sites or r >= nr:
                    continue
                for mu in _directions(g.D, d):
                    key = (site, r0 + r, mu)
                    seen[key] = seen.get(key, 0) + 1
    assert len(seen) == row_sites * nrhs * 4
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_geometry_fits_a_block(itemsize):
    """Threads and shared memory fit one block at every source count;
    the partial sums fit the link region; warps hold one direction
    group; directions split only where a full tile's links outgrow the
    budget."""
    for nrhs in list(range(1, 25)) + [48, 100]:
        for Z, Y, Xh in ROWS:
            g = geo.tile_geometry(Z, Y, Xh, nrhs, itemsize)
            geo.check_geometry(g, itemsize)
            assert g.threads == g.D * g.G * g.S <= geo.MAX_THREADS
            assert g.G <= geo.MAX_GROUP and g.G * g.groups >= nrhs
            assert g.G * (g.groups - 1) < nrhs
            assert g.tiles * g.S >= Z * Y * Xh > (g.tiles - 1) * g.S
            assert g.smem == g.S * geo.LINK_PLANES * itemsize
            assert g.smem <= geo.SMEM_BUDGET_BYTES
            if g.D > 1:
                assert (g.G * g.S) % 32 == 0
                assert g.D * 24 * g.G <= geo.LINK_PLANES
                assert 8 * -(-128 // (8 * g.G)) * geo.LINK_PLANES * \
                    itemsize > geo.SMEM_BUDGET_BYTES


def test_geometry_does_not_depend_on_the_lattice_row():
    """D, G and S (hence the summation order) depend on the sources and
    the real type only; f32, the driven paths, keeps D = 1 with groups of
    at most 4 sources; f64 splits the directions of one source."""
    for nrhs in NRHS:
        for it in (4, 8):
            shapes = {(g.D, g.G, g.S) for g in
                      (geo.tile_geometry(Z, Y, Xh, nrhs, it)
                       for Z, Y, Xh in ROWS)}
            assert len(shapes) == 1
    assert [(g.D, g.G, g.groups, g.S) for g in
            (geo.tile_geometry(16, 16, 8, n, 4) for n in NRHS)] == \
        [(1, 1, 1, 128), (1, 2, 1, 64), (1, 3, 1, 48), (1, 3, 2, 48),
         (1, 4, 3, 32), (1, 4, 4, 32), (1, 4, 6, 32)]
    assert [(g.D, g.S) for g in (geo.tile_geometry(16, 16, 8, n, 8)
                                 for n in (1, 2, 3))] == \
        [(2, 64), (1, 64), (1, 48)]


def test_geometry_refuses_what_cannot_launch():
    with pytest.raises(ValueError, match="nrhs"):
        geo.tile_geometry(4, 4, 4, 0, 4)
    g = geo.tile_geometry(4, 4, 4, 1, 4)
    with pytest.raises(ValueError, match="threads"):
        geo.check_geometry(geo.TileGeometry(1, 12, 1, 32, 1, 384, 1 << 16),
                           4)
    for smem in (g.smem - 1, geo.SMEM_LIMIT_BYTES + 1):
        with pytest.raises(ValueError, match="shared memory"):
            geo.check_geometry(geo.TileGeometry(
                g.D, g.G, g.groups, g.S, g.tiles, g.threads, smem), 4)
    with pytest.raises(ValueError, match="D must be"):
        geo.check_geometry(geo.TileGeometry(4, 1, 1, 32, 1, 128,
                                            32 * 144 * 4), 4)
    with pytest.raises(ValueError, match="partial sums"):
        geo.check_geometry(geo.TileGeometry(2, 4, 1, 16, 1, 128,
                                            16 * 144 * 4), 4)


@pytest.mark.parametrize("gc", [12, 8])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4])
def test_in_place_expansion_reads_each_raw_link_before_it_is_overwritten(
        gc, lanes):
    """hop_tile's stage 2 on one site's column of the link region: the 8
    raw links (``gc`` planes each) sit at its end, and rounds of
    ``lanes`` threads each read one raw link, then (after a barrier when
    ``lanes > 1``) write its 18 expanded planes from the start.  Every
    read finds its raw planes intact and the column ends expanded."""
    off = geo.LINK_PLANES - 8 * gc
    col = [None] * off + [("raw", slot, c) for slot in range(8)
                          for c in range(gc)]
    for first in range(0, 8, lanes):
        slots = [sl for sl in range(first, first + lanes) if sl < 8]
        for sl in slots:
            assert col[off + sl * gc: off + (sl + 1) * gc] == \
                [("raw", sl, c) for c in range(gc)]
        for sl in slots:
            col[18 * sl: 18 * (sl + 1)] = [("u", sl, k) for k in range(18)]
    assert col == [("u", sl, k) for sl in range(8) for k in range(18)]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_hop_geometry_keeps_the_direction_split_of_b2(itemsize):
    """B1's D (hence each thread's summation order) and G are B2's at
    every source count and row; only the tile may shrink, to no less
    than a warp of threads and whole warps per direction group; it
    shrinks only while the launch has fewer than HOP_MIN_BLOCKS blocks."""
    for nrhs in list(range(1, 25)) + [48]:
        for T in (1, 3, 16, 64):
            for Z, Y, Xh in ROWS + [(32, 32, 32)]:
                b2 = geo.tile_geometry(Z, Y, Xh, nrhs, itemsize)
                g = geo.hop_geometry(T, Z, Y, Xh, nrhs, itemsize)
                geo.check_geometry(g, itemsize)
                assert (g.D, g.G, g.groups) == (b2.D, b2.G, b2.groups)
                assert g.S <= b2.S and b2.S % g.S == 0
                assert g.threads == g.D * g.G * g.S
                assert g.tiles * g.S >= Z * Y * Xh > (g.tiles - 1) * g.S
                assert g.smem == geo.smem_bytes(g.S, itemsize)
                if g.D > 1:
                    assert (g.G * g.S) % 32 == 0
                if g.S < b2.S:
                    assert g.threads >= 32
                    # One more halving was due: the block count was short.
                    assert T * -(-Z * Y * Xh // (2 * g.S)) * g.groups < \
                        geo.HOP_MIN_BLOCKS


def test_hop_geometry_at_the_main_lattices():
    """16^4 with one source takes 32-site tiles (1024 blocks, where B2's
    128-site tiles would give 256); wilson-64x16x16x8 keeps B2's tile;
    the propagator's block keeps B2's 32-site tiles."""
    assert [(g.D, g.G, g.groups, g.S, 16 * g.tiles * g.groups) for g in (
        geo.hop_geometry(16, 16, 16, 8, 1, 4),
        geo.hop_geometry(16, 16, 16, 32, 1, 4),
        geo.hop_geometry(16, 16, 16, 8, 12, 4),
        geo.hop_geometry(16, 16, 16, 8, 1, 8))] == \
        [(1, 1, 1, 32, 1024), (1, 1, 1, 128, 1024), (1, 4, 3, 32, 3072),
         (2, 1, 1, 32, 1024)]


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("nrhs", [1, 4, 5, 12])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_hop_blocks_cover_every_row_tile_group_once(row, T, nrhs,
                                                    itemsize):
    """B1's blocks, decoded as the kernel decodes blockIdx, and their
    threads (d, r, s) cover each (t, site, source, direction) once."""
    Z, Y, Xh = row
    g = geo.hop_geometry(T, Z, Y, Xh, nrhs, itemsize)
    per_row = g.tiles * g.groups
    row_sites = Z * Y * Xh
    seen = {}
    for w in range(T * per_row):
        t, grp, tile = w // per_row, (w % per_row) // g.tiles, w % g.tiles
        r0 = grp * g.G
        nr = min(g.G, nrhs - r0)
        for tid in range(g.threads):
            d, r, s = (tid // (g.G * g.S), (tid // g.S) % g.G, tid % g.S)
            site = tile * g.S + s
            if site >= row_sites or r >= nr:
                continue
            for mu in _directions(g.D, d):
                key = (t, site, r0 + r, mu)
                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == T * row_sites * nrhs * 4
    assert set(seen.values()) == {1}


def _wide_slot(k):
    """wilson_site_tile.cuh's wide_slot: the k-th slot copied in runs."""
    return 2 * k if k < 4 else (5 if k == 4 else (7 if k == 5 else 3))


def _link_index(T, Z, Y, Xh, gc, mu, t, z, y, x, c):
    """Element (mu, t, z, c, y, x) of a planar gauge (4, T, Z, gc, Y,
    Xh)."""
    return ((((mu * T + t) * Z + z) * gc + c) * Y + y) * Xh + x


def _site_link(T, Z, Y, Xh, gc, halo, slot, t, site, c, out_parity,
               tz_par):
    """(array, index) of plane c of link slot ``slot`` of output site
    ``site`` of row t, from the stencil's definition: forward links at
    the site in u_out; backward ones at its -mu neighbour in u_in,
    periodic or, in halo mode, in the array extended by 2 in t and z."""
    x, y, z = site % Xh, (site // Xh) % Y, site // (Xh * Y)
    mu = slot // 2
    if slot % 2 == 0:
        return "out", _link_index(T, Z, Y, Xh, gc, mu, t, z, y, x, c)
    row = (t + z + y + tz_par) % 2
    xb = (x - 1) % Xh if row == out_parity % 2 else x
    h = 1 if halo else 0
    tt, zz, yy, xx = t + h, z + h, y, x
    if mu == 0:
        xx = xb
    elif mu == 1:
        yy = (y - 1) % Y
    elif mu == 2:
        zz = z if halo else (z - 1) % Z
    else:
        tt = t if halo else (t - 1) % T
    return "in", _link_index(T + 2 * h, Z + 2 * h, Y, Xh, gc, mu, tt, zz,
                             yy, xx, c)


@pytest.mark.parametrize("row", ROWS + [(4, 2, 6), (2, 4, 8)])
@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("gc", [18, 8])
def test_link_copies_land_every_plane_of_a_tile_once(row, nrhs, itemsize,
                                                     halo, gc):
    """Stage 1 of hop_tile, as the kernel assigns its copies to threads
    (16-byte runs of V sites where the tile and the plane are multiples
    of V, the y slot only where Xh is; one real at a time for the rest):
    every (slot, plane, site) of a tile's live sites is copied exactly
    once, and every copy of a run reads V consecutive reals, each the
    link the stencil names for its site (four tiles of each row)."""
    Z, Y, Xh = row
    T = 3
    V = 16 // itemsize
    g = geo.hop_geometry(T, Z, Y, Xh, nrhs, itemsize)
    plane, row_sites = Y * Xh, Z * Y * Xh
    lanes = g.D * g.G
    wide = g.S % V == 0 and plane % V == 0
    wide_y = Xh % V == 0
    for t in (0, T - 1):
        for parity in (0, 1):
            # The first tiles, one inside and the ragged last one.
            for tile in sorted({0, 1, g.tiles // 2, g.tiles - 1}
                               & set(range(g.tiles))):
                site0 = tile * g.S
                got = {}

                def land(slot, c, s, src):
                    key = (slot, c, s)
                    assert key not in got, f"{key} copied twice"
                    got[key] = src
                for tid in range(g.threads):
                    s, lane = tid % g.S, tid // g.S
                    if site0 + s >= row_sites:
                        continue
                    if wide:
                        j, first = lane * V + s % V, site0 + s - s % V
                        for k in range(j, 7 if wide_y else 6, V * lanes):
                            slot = _wide_slot(k)
                            for c in range(gc):
                                arr, own = _site_link(
                                    T, Z, Y, Xh, gc, halo, slot, t,
                                    site0 + s, c, parity, 1)
                                for i in range(V):
                                    land(slot, c, first - site0 + i,
                                         (arr, own - s % V + i))
                    singles = (1 if wide_y else 2) if wide else 8
                    for k in range(lane, singles, lanes):
                        slot = (1 if k == 0 else 3) if wide else k
                        for c in range(gc):
                            land(slot, c, s, _site_link(
                                T, Z, Y, Xh, gc, halo, slot, t, site0 + s,
                                c, parity, 1))
                live = range(min(g.S, row_sites - site0))
                assert got == {(slot, c, s): _site_link(
                    T, Z, Y, Xh, gc, halo, slot, t, site0 + s, c, parity, 1)
                    for slot in range(8) for c in range(gc) for s in live}
    if (Z, Y, Xh) == (16, 16, 8):
        assert wide and wide_y


@pytest.mark.parametrize("window", [4, 5, 6])
def test_stream_flags_and_ring_do_not_grow_with_T(window):
    g = geo.tile_geometry(16, 16, 8, 24, 4)
    words = geo.stream_flag_words(g, window, 16)
    assert g.groups == 6 and words == 1 + 2 * window * 6 * 16
    for T in (4, 16, 64):
        assert ws.stream_ring_bytes((12, T, 16, 24, 16, 8), 4, window) == \
            4 * window * 16 * 24 * 12 * 16 * 8


@pytest.mark.parametrize("T", [1, 2, 3, 8])
def test_stream_task_list_is_the_reference_schedule(T):
    """Decoded tasks: each produce step 0..T+1 and each consume step
    3..T+2 once per (group, tile), produce before consume within a
    step, in step order."""
    per = 5
    tasks = [geo.stream_task(w, T, per) for w in range((2 * T + 2) * per)]
    prod = [(s, k) for s, p, k in tasks if p]
    cons = [(s, k) for s, p, k in tasks if not p]
    assert prod == [(s, k) for s in range(T + 2) for k in range(per)]
    assert cons == [(s, k) for s in range(3, T + 3) for k in range(per)]
    keys = [(s, not p) for s, p, _ in tasks]
    assert keys == sorted(keys)
    with pytest.raises(ValueError, match="past the end"):
        geo.stream_task((2 * T + 2) * per, T, per)


def _simulate_stream(T, Z, plane, S, groups, window, blocks, seed,
                     launches=2):
    """Run B3's task list as the kernel does — tasks dealt round robin to
    ``blocks`` resident blocks, each block in list order, a task starting
    once the counters of the planes it waits for
    (``geometry.stream_waits``, planes ``tile_planes`` +-1) reach their
    targets — picking the next block at random.  Checks that no schedule
    deadlocks, that every consumer finds the rows its step needs at the
    sites it reads, and that no producer overwrites a site a pending
    consumer still reads; the counters end each launch at zero, as the
    kernel's last block leaves them, and serve the next launch."""
    rng = random.Random(seed)
    tiles = -(-Z * plane // S)
    per = tiles * groups
    count = {}
    ring = {}                     # (slot, group, site) -> (row, launch)

    def planes(tile):
        za, zb = geo.tile_planes(tile, S, plane, Z)
        if zb - za + 3 >= Z:
            return list(range(Z))
        return [z % Z for z in range(za - 1, zb + 2)]

    def sites_on(zs):
        return [site for z in zs for site in range(z * plane,
                                                   (z + 1) * plane)]

    for launch in range(launches):
        ntasks = (2 * T + 2) * per
        queues = [list(range(b, ntasks, blocks)) for b in range(blocks)]
        slow = rng.randrange(blocks)
        consumed = set()
        while any(queues):
            ready = []
            for b, q in enumerate(queues):
                if not q:
                    continue
                s, produce, k = geo.stream_task(q[0], T, per)
                grp, tile = divmod(k, tiles)
                if all(count.get((kind, slot, grp, z), 0) >=
                       uses * geo.tiles_on_plane(z, S, plane)
                       for kind, slot, uses in
                       geo.stream_waits(s, produce, window)
                       for z in planes(tile)):
                    ready.append(b)
            assert ready, f"deadlock (T={T}, window={window})"
            # One block runs slowly, so that late tasks of early steps
            # meet early tasks of late ones.
            b = rng.choices(ready, [0.02 if r == slow else 1.0
                                    for r in ready])[0]
            s, produce, k = geo.stream_task(queues[b].pop(0), T, per)
            grp, tile = divmod(k, tiles)
            za, zb = geo.tile_planes(tile, S, plane, Z)
            own = range(tile * S, min(tile * S + S, Z * plane))
            if produce:
                # Every consumer of the slot's old row that reads one of
                # these sites (its planes +-1) has finished.
                for c in range(max(3, s - window + 1), s - window + 4):
                    for j in range(tiles):
                        if set(own) & set(sites_on(planes(j))):
                            assert (c, grp * tiles + j) in consumed
                for site in own:
                    ring[(s % window, grp, site)] = ((s - 1) % T, launch)
                kind, slot = "produce", s % window
            else:
                t = (s - 3) % T
                for p, row in ((s - 2, t), (s - 1, (t + 1) % T),
                               (s - 3, (t - 1) % T)):
                    for site in sites_on(planes(tile)):
                        assert ring.get((p % window, grp, site)) == \
                            (row, launch)
                consumed.add((s, k))
                kind, slot = "consume", (s - 3) % window
            for z in range(za, zb + 1):
                key = (kind, slot, grp, z)
                count[key] = count.get(key, 0) + 1
        count = {}


@pytest.mark.parametrize("T,Z,plane,S,groups,window,blocks", [
    (1, 4, 16, 32, 1, 4, 3), (2, 5, 15, 16, 2, 4, 7),
    (4, 5, 15, 32, 1, 4, 2), (5, 3, 16, 16, 1, 6, 5),
    (6, 7, 12, 16, 2, 5, 11), (8, 4, 32, 32, 1, 8, 4),
    (16, 6, 8, 16, 1, 4, 40),
])
def test_stream_counters_order_every_schedule(T, Z, plane, S, groups,
                                              window, blocks):
    for seed in range(3):
        _simulate_stream(T, Z, plane, S, groups, window, blocks, seed)


@pytest.mark.parametrize("Z,plane,S", [(16, 128, 32), (5, 15, 32),
                                        (7, 15, 16), (3, 16, 48)])
def test_tiles_on_plane_counts_the_covering_tiles(Z, plane, S):
    tiles = -(-Z * plane // S)
    for z in range(Z):
        covering = [j for j in range(tiles)
                    if geo.tile_planes(j, S, plane, Z)[0] <= z
                    <= geo.tile_planes(j, S, plane, Z)[1]]
        assert geo.tiles_on_plane(z, S, plane) == len(covering)


def test_stream_waits_count_uses_of_each_slot():
    """The targets count the uses of a slot up to the awaited step."""
    assert geo.stream_waits(0, True, 4) == []
    assert geo.stream_waits(3, False, 4) == [("produce", 2, 1),
                                             ("produce", 1, 1),
                                             ("produce", 0, 1)]
    # Produce step 9 (window 4) overwrites slot 1, read by the consume
    # steps 6, 7, 8: uses 1 of slots 3, 0 and 2 of slot 1.
    assert geo.stream_waits(9, True, 4) == [("consume", 3, 1),
                                            ("consume", 0, 2),
                                            ("consume", 1, 2)]

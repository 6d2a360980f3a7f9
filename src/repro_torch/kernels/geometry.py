"""Launch geometry of the kernels B1, B2 and B3.

All three run the tile routine of ``csrc/wilson_site_tile.cuh``: a
block handles ``S`` sites of one t-row for a group of ``G`` right-hand
sides, with ``D`` threads per (site, source), each summing one group of
directions.  This module chooses those numbers, the shared-memory bytes
a block needs and, for B3, the size of its flags buffer, so that the
CPU tests can check them; the wrappers pass them to the C entry points,
which refuse a geometry that does not fit the kernel.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["TileGeometry", "tile_geometry", "hop_geometry", "smem_bytes",
           "stream_flag_words", "stream_task", "stream_waits",
           "tile_planes", "tiles_on_plane", "check_geometry",
           "MAX_THREADS", "MAX_GROUP", "TARGET_THREADS", "LINK_PLANES",
           "SMEM_LIMIT_BYTES", "SMEM_BUDGET_BYTES", "HOP_MIN_BLOCKS"]

#: most threads of one block (``wilson::tile::kMaxThreads``)
MAX_THREADS = 192
#: most sources one block handles (measured: groups of 4 beat 12)
MAX_GROUP = 4
#: threads a block aims at; S is the smallest multiple of 8 reaching it
TARGET_THREADS = 128
#: reals of shared memory per tile site: its 8 links, expanded in place
#: whatever their form (``wilson::tile::kLinkPlanes``)
LINK_PLANES = 8 * 18
#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT_BYTES = 232448
#: shared memory a tile's links may take: a third of the SM's 227 KB,
#: so that the 3 blocks of 128 threads that the 168-register cap lets
#: an SM hold also fit its shared memory
SMEM_BUDGET_BYTES = 232448 // 3
#: blocks a launch of B1 should have at least: its tiles shrink (down to
#: one warp of threads) until the launch has this many, so that the 132
#: SMs of an H100 each get about 8 blocks to interleave
HOP_MIN_BLOCKS = 1024
# 64-bit words ahead of B3's counters: the launch's finished blocks.
_FLAG_HEADER = 1


@dataclass(frozen=True)
class TileGeometry:
    """``D`` direction groups per (site, source); ``G`` sources per
    group and ``groups`` groups; ``S`` sites per tile and ``tiles``
    tiles per t-row; ``threads`` per block and ``smem`` bytes of dynamic
    shared memory per block."""
    D: int
    G: int
    groups: int
    S: int
    tiles: int
    threads: int
    smem: int

    @property
    def tasks_per_row(self) -> int:
        """Blocks' worth of work per t-row: tiles x source groups."""
        return self.tiles * self.groups


def smem_bytes(S: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (``wilson::tile::smem_bytes``);
    the ``D`` partial sums reuse the link region once the links are
    read, so ``D * 24 * G <= LINK_PLANES`` when ``D > 1``."""
    return S * LINK_PLANES * itemsize


@functools.lru_cache(maxsize=None)
def tile_geometry(Z: int, Y: int, Xh: int, nrhs: int,
                  itemsize: int) -> TileGeometry:
    """The geometry of B2 and B3 for a lattice row of ``Z * Y * Xh``
    sites, ``nrhs`` sources and ``itemsize``-byte reals.

    Sources split into the fewest groups of at most ``MAX_GROUP``, as
    even as possible; a tile has the fewest sites (a multiple of 8) that
    give a block ``TARGET_THREADS``.  One thread sums all 8 terms of a
    site (``D = 1``) while the tile's links fit ``SMEM_BUDGET_BYTES``;
    where they do not (f64 with one source), the terms of a site split
    over ``D = 2`` threads, which keeps the block's threads on half the
    sites.  Every link form takes the same shared memory (compressed
    links are expanded in place), so the geometry does not depend on
    it.  B2 and B3 take the same geometry, hence the same summation
    order.
    """
    if min(Z, Y, Xh, nrhs) < 1:
        raise ValueError(f"tile_geometry: need Z, Y, Xh, nrhs >= 1; got "
                         f"{(Z, Y, Xh, nrhs)}")
    groups = -(-nrhs // MAX_GROUP)
    G = -(-nrhs // groups)
    D = 1
    S = 8 * -(-TARGET_THREADS // (8 * G))
    if smem_bytes(S, itemsize) > SMEM_BUDGET_BYTES and 2 * 24 * G <= \
            LINK_PLANES:
        # G * S stays a multiple of 32: no warp straddles two direction
        # groups.
        D = 2
        S = 8 * -(-TARGET_THREADS // (8 * D * G))
    while smem_bytes(S, itemsize) > SMEM_BUDGET_BYTES and S > 8:
        S -= 8
    return TileGeometry(D=D, G=G, groups=groups, S=S,
                        tiles=-(-Z * Y * Xh // S), threads=D * G * S,
                        smem=smem_bytes(S, itemsize))


@functools.lru_cache(maxsize=None)
def hop_geometry(T: int, Z: int, Y: int, Xh: int, nrhs: int,
                 itemsize: int) -> TileGeometry:
    """The geometry of B1 for ``T`` t-rows of ``Z * Y * Xh`` sites.

    ``D`` and ``G`` are those of :func:`tile_geometry` (B2's and B3's),
    so that the two-launch ``Dhat`` sums each site in their order.  B1
    launches one block per (t-row, tile, source group) and nothing
    else, so where B2's tile leaves fewer than ``HOP_MIN_BLOCKS``
    blocks, the tile halves, as long as a block keeps a warp of threads
    and, with ``D > 1``, whole warps per direction group.
    """
    g = tile_geometry(Z, Y, Xh, nrhs, itemsize)
    S = g.S
    while (T * -(-Z * Y * Xh // S) * g.groups < HOP_MIN_BLOCKS
           and S % 16 == 0 and g.D * g.G * (S // 2) >= 32
           and (g.D == 1 or g.G * (S // 2) % 32 == 0)):
        S //= 2
    return TileGeometry(D=g.D, G=g.G, groups=g.groups, S=S,
                        tiles=-(-Z * Y * Xh // S), threads=g.D * g.G * S,
                        smem=smem_bytes(S, itemsize))


def stream_flag_words(geom: TileGeometry, window: int, Z: int) -> int:
    """64-bit words of B3's counters: the finished blocks of a launch,
    one produce counter per (ring slot, source group, z plane) and one
    consume counter per (consume step % window, source group, z plane)
    — independent of T."""
    return _FLAG_HEADER + 2 * window * geom.groups * Z


def check_geometry(geom: TileGeometry, itemsize: int) -> None:
    """Raise if a geometry cannot launch with ``itemsize``-byte reals:
    too many threads, a direction split other than 1 or 2, too little or
    too much shared memory, or D partial sums that do not fit the link
    region."""
    if (geom.threads > MAX_THREADS
            or geom.threads != geom.D * geom.G * geom.S):
        raise ValueError(f"tile geometry {geom}: needs D*G*S threads, at "
                         f"most {MAX_THREADS}")
    if geom.D not in (1, 2):
        raise ValueError(f"tile geometry {geom}: D must be 1 or 2")
    need = smem_bytes(geom.S, itemsize)
    if not need <= geom.smem <= SMEM_LIMIT_BYTES:
        raise ValueError(f"tile geometry {geom}: shared memory must lie "
                         f"between {need} and {SMEM_LIMIT_BYTES} B")
    if geom.D > 1 and geom.D * 24 * geom.G > LINK_PLANES:
        raise ValueError(f"tile geometry {geom}: the D partial sums do "
                         "not fit the link region")


def stream_task(w: int, T: int, per_step: int) -> Tuple[int, bool, int]:
    """Task ``w`` of B3's list as ``(step, produce, k)``, ``k`` the
    (group, tile) index ``group * tiles + tile``: steps 0-2 produce only,
    steps 3..T+1 produce then consume, step T+2 consumes; the list holds
    ``(2T + 2) * per_step`` tasks.  The kernel decodes its tasks so."""
    if not 0 <= w < (2 * T + 2) * per_step:
        raise ValueError(f"task {w} past the end of the list")
    if w < 3 * per_step:
        return w // per_step, True, w % per_step
    s, k = divmod(w - 3 * per_step, 2 * per_step)
    s += 3
    if s > T + 1:
        return s, False, k
    return (s, True, k) if k < per_step else (s, False, k - per_step)


def stream_waits(step: int, produce: bool, window: int
                 ) -> List[Tuple[str, int, int]]:
    """What a B3 task of ``step`` waits for, as ``(counter, slot, uses)``:
    counter ``"produce"`` or ``"consume"``, its slot, and how many uses
    of that slot must be complete on the z planes the task reads or
    writes and one on either side (:func:`tile_planes`).  A consume task
    waits for the rows of steps s-1..s-3; a produce task for the consume
    steps s-window+1..s-window+3 that read the slot it overwrites.
    Produce step p is use ``p // window + 1`` of slot ``p % window``;
    consume step c is use ``(c - 3) // window + 1`` of slot
    ``(c - 3) % window``.  The kernel waits so."""
    out = []
    for j in (1, 2, 3):
        use = step - window + j - 3 if produce else step - j
        if use >= 0:
            out.append(("consume" if produce else "produce", use % window,
                        use // window + 1))
    return out


def tile_planes(tile: int, S: int, plane: int, Z: int) -> Tuple[int, int]:
    """The z planes ``(za, zb)`` that tile ``tile`` of ``S`` sites covers
    in a t-row of ``Z`` planes of ``plane`` sites."""
    first = tile * S
    return first // plane, (min(first + S, Z * plane) - 1) // plane


def tiles_on_plane(z: int, S: int, plane: int) -> int:
    """How many tiles of ``S`` sites cover z plane ``z``: a plane is
    complete in a use of a slot when its counter has counted them all."""
    return ((z + 1) * plane - 1) // S - z * plane // S + 1

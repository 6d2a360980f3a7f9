"""Distributed even-odd Wilson operator over a ``torch.distributed`` group.

The lattice is split over t (``t_ranks``) and z (``z_ranks``) between
the ranks of a group (:class:`QCDPartition`); every function here acts
on this rank's block ``([nrhs,] Tl, Zl, 24, Y, Xh)`` and exchanges t and
z halos with its neighbours (:mod:`repro_torch.distributed.halo`).

Three overlap modes (paper Sec. 3.5/3.6), as the reference's:

* ``fused``: halo-extend the source (t faces, then z faces), then one
  halo-mode hop over the extended block;
* ``interior``: the four source faces go first (on a side CUDA stream);
  the interior ``(Tl-2, Zl-2)`` block, whose stencil reach lies inside
  the local block, runs on the caller's stream while they are in
  flight; a CUDA event then orders four thin boundary slabs (two t-rows
  ``(3, Zl+2) -> (1, Zl)``, two z-columns ``(Tl+2, 3) -> (Tl, 1)``)
  after the landed faces;
* ``split``: the bulk runs periodic on the local block while the faces
  are in flight, then the four boundary slabs are recomputed from the
  halos and written over it (one source only).

The local stencil (``QCDPartition.backend``) is ``cuda_hop``, kernel B1
in halo mode (periodic for ``split``'s bulk), which on CPU tensors runs
its plain version; ``torch_planar``, the plain planar stencil; or
``torch_ref``, the complex round trip
(:func:`repro_torch.kernels.ref.hop_block_ext_planar`).  ``None`` picks
``cuda_hop`` on a CUDA device and ``torch_planar`` on the CPU.  B1 takes
contiguous operands only, so the slabs are copied out, and the gauge
pieces they need are cut once, at bind (:func:`bind_links`): the gauge
never changes within a bind.  With ``hoist_gauge`` (the default here;
the reference's default is off) the gauge's halos are exchanged once at
bind, not in every hop.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import evenodd
from ..kernels import layout, ref
from ..kernels import wilson_stencil as ws
from . import halo

__all__ = ["QCDPartition", "Shard", "LocalLinks", "BoundLinks", "bind_links",
           "make_gauge_extender", "make_hop_fn", "make_dhat_fn",
           "make_dhat_dagger_fn", "make_block_oracle", "normalize_overlap",
           "LOCAL_STENCILS", "OVERLAPS"]

LOCAL_STENCILS = ("cuda_hop", "torch_planar", "torch_ref")
OVERLAPS = ("fused", "interior", "split")


def normalize_overlap(overlap):
    """The boolean comms/compute-overlap knob as a mode: ``True`` is
    ``"interior"`` (overlap the exchange with the interior stencil),
    ``False`` ``"fused"``; anything else passes through."""
    if overlap is True:
        return "interior"
    if overlap is False:
        return "fused"
    return overlap


@dataclasses.dataclass(frozen=True)
class QCDPartition:
    """How the lattice maps onto the ranks of a process group.

    ``group=None`` is one rank and needs no ``torch.distributed``;
    ``t_ranks x z_ranks`` must be the group's size (``t_ranks=None``:
    the whole group over t, the reference's default ``(devices, 1)``
    mesh); ``backend`` the local stencil (:data:`LOCAL_STENCILS`, or
    ``None`` by device); ``overlap`` one of :data:`OVERLAPS`."""

    group: Optional[object] = None
    t_ranks: Optional[int] = None
    z_ranks: int = 1
    backend: Optional[str] = None
    overlap: str = "fused"
    hoist_gauge: bool = True

    def __post_init__(self):
        if self.t_ranks is None:
            world = 1 if self.group is None else \
                dist.get_world_size(self.group)
            object.__setattr__(self, "t_ranks", world // self.z_ranks)
        if self.overlap not in OVERLAPS:
            raise ValueError(f"unknown overlap mode {self.overlap!r}: "
                             "expected 'fused', 'interior' or 'split'")
        if self.backend is not None and self.backend not in LOCAL_STENCILS:
            raise ValueError(f"unknown local stencil {self.backend!r}; "
                             f"choose from {LOCAL_STENCILS}")
        self.grid    # raises if the grid does not match the group

    @property
    def grid(self) -> halo.TZGrid:
        return halo.TZGrid(self.group, self.t_ranks, self.z_ranks)

    @property
    def world(self) -> int:
        return self.t_ranks * self.z_ranks

    def stencil(self, device) -> str:
        """The local stencil on ``device``."""
        if self.backend is not None:
            return self.backend
        return "cuda_hop" if torch.device(device).type == "cuda" \
            else "torch_planar"

    def local_extents(self, T: int, Z: int) -> Tuple[int, int]:
        """This rank's ``(Tl, Zl)`` of a ``(T, Z)`` lattice; raises where
        the grid does not divide it."""
        if T % self.t_ranks or Z % self.z_ranks:
            raise ValueError(
                f"a {self.t_ranks} x {self.z_ranks} grid does not divide "
                f"the lattice's (T, Z) = {(T, Z)}")
        return T // self.t_ranks, Z // self.z_ranks

    def check_block(self, Tl: int, Zl: int, *, batched: bool = False):
        """Raise where the overlap mode cannot take a ``(Tl, Zl)`` block
        (``batched``: with a leading ``nrhs`` axis)."""
        if self.overlap == "interior" and (Tl < 3 or Zl < 3):
            raise ValueError("overlap='interior' needs local T,Z >= 3 (a "
                             "non-empty interior after peeling one boundary "
                             "plane per side); use 'fused' for thin shards")
        if self.overlap == "split":
            if batched:
                raise ValueError("multi-RHS batching requires "
                                 "overlap='fused' or 'interior' (the split "
                                 "boundary-recompute path is single-RHS "
                                 "only)")
            if Tl < 2 or Zl < 2:
                raise ValueError("overlap='split' needs local T,Z >= 2; "
                                 "use 'fused'")


class Shard(NamedTuple):
    """This rank's block of a lattice split between the ranks of
    ``grid``: its global ``origin`` ``(t0, z0)``, its ``extents`` ``(Tl,
    Zl)`` and the planar real ``dtype`` of its native vectors.

    :meth:`block` cuts the block out of a global array, :meth:`gather`
    puts the global array together from every rank's block (one
    ``all_gather``), and :meth:`encode` / :meth:`decode` convert a
    complex block to and from the native planar block with no
    collective, so that a loop may leave the native domain."""

    grid: halo.TZGrid
    origin: Tuple[int, int]
    extents: Tuple[int, int]
    dtype: torch.dtype

    def block(self, a: torch.Tensor, t_axis: int) -> torch.Tensor:
        """The rank's ``(Tl, Zl)`` block of ``a``'s global ``(T, Z)`` axes
        at ``t_axis`` and ``t_axis + 1`` (a view)."""
        (t0, z0), (Tl, Zl) = self.origin, self.extents
        return a.narrow(t_axis, t0, Tl).narrow(t_axis + 1, z0, Zl)

    def gather(self, a: torch.Tensor, t_axis: int) -> torch.Tensor:
        """The global array of every rank's block ``a``, on every rank."""
        return halo.gather_tz(self.grid, a, t_axis)

    def encode(self, psi: torch.Tensor) -> torch.Tensor:
        """Complex block ``([n,] Tl, Zl, Y, Xh, 4, 3)`` -> native planar
        block."""
        return layout.spinor_to_planar(psi, dtype=self.dtype)

    def decode(self, v: torch.Tensor) -> torch.Tensor:
        """Native planar block -> complex block."""
        return layout.spinor_from_planar(v)


def _extend_complex(a: torch.Tensor, grid: halo.TZGrid,
                    t_axis: int) -> torch.Tensor:
    """:func:`halo.extend_tz` of a complex array, its faces sent as
    reals."""
    return torch.view_as_complex(halo.extend_tz(
        torch.view_as_real(a), grid, t_axis, t_axis + 1))


def make_block_oracle(shard: Shard, U_e: torch.Tensor, U_o: torch.Tensor):
    """The complex even-odd operators on this rank's block of complex
    spinors ``([nrhs,] Tl, Zl, Y, Xh, 4, 3)``, from the global complex
    gauge halves: ``(hop_oe, hop_eo, dhat)``, ``dhat(psi, kappa)``.

    The gauge is cut to the block and halo-extended once, here.  Each
    hop halo-extends its source (t faces, then z faces; a block of
    sources in one message per face) and applies
    :func:`repro_torch.core.evenodd.hop_block_ext` with the block's
    parity offset, mapped over the leading axis of a block after the
    exchange: the refined solve's f64 operator on a split lattice, which
    shares nothing with the kernels under test."""
    grid = shard.grid
    u_e, u_o = (shard.block(u, 1) for u in (U_e, U_o))
    u_e_ext, u_o_ext = (_extend_complex(u, grid, 1) for u in (u_e, u_o))
    off = sum(shard.origin) % 2

    def hop(src, out_parity):
        lead = src.ndim - 6
        src_ext = _extend_complex(src, grid, lead)
        u_out, u_in = ((u_o, u_e_ext) if out_parity == evenodd.ODD
                       else (u_e, u_o_ext))

        def one(s):
            return evenodd.hop_block_ext(u_out, u_in, s, out_parity, off)
        return torch.func.vmap(one)(src_ext) if lead else one(src_ext)

    def hop_oe(psi_e):
        return hop(psi_e, evenodd.ODD)

    def hop_eo(psi_o):
        return hop(psi_o, evenodd.EVEN)

    def dhat(psi_e, kappa):
        return psi_e - (kappa * kappa) * hop_eo(hop_oe(psi_e))

    return hop_oe, hop_eo, dhat


def _slabs(Tl: int, Zl: int):
    """The four boundary slabs as ``((t, z) of the extended source, (t,
    z) of the output, (dt, dz) origin offset)``: two t-rows over the
    whole z extent, two z-columns over the whole t extent."""
    a = slice(None)
    return (((slice(0, 3), a), (slice(0, 1), a), (0, 0)),
            ((slice(Tl - 1, Tl + 2), a), (slice(Tl - 1, Tl), a), (Tl - 1, 0)),
            ((a, slice(0, 3)), (a, slice(0, 1)), (0, 0)),
            ((a, slice(Zl - 1, Zl + 2)), (a, slice(Zl - 1, Zl)), (0, Zl - 1)))


class LocalLinks(NamedTuple):
    """One parity's links on this rank, cut at bind: ``local`` ``(4, Tl,
    Zl, gc, Y, Xh)``; ``ext`` its halo extension (with ``hoist_gauge``,
    else ``None``); as output-parity links, ``inner`` (the interior
    block) and ``out_slabs`` (the four boundary slabs); as source-parity
    links, ``in_slabs`` (the extended slabs, with ``hoist_gauge``).
    Contiguous, as B1 takes them."""

    local: torch.Tensor
    ext: Optional[torch.Tensor]
    inner: Optional[torch.Tensor]
    out_slabs: Optional[tuple]
    in_slabs: Optional[tuple]


class BoundLinks(NamedTuple):
    """Both parities' :class:`LocalLinks` and the side CUDA stream of the
    exchanges (``None`` on the CPU)."""

    even: LocalLinks
    odd: LocalLinks
    stream: Optional[object]


def make_gauge_extender(part: QCDPartition):
    """Returns ``f(u_local) -> halo-extended gauge`` (one exchange)."""
    def extend(u):
        return halo.extend_tz(u, part.grid, 1, 2)
    return extend


def _cut(a: torch.Tensor, lead: int, sl_t, sl_z) -> torch.Tensor:
    return a[(slice(None),) * lead + (sl_t, sl_z)].contiguous()


def bind_links(part: QCDPartition, u_e: torch.Tensor,
               u_o: torch.Tensor) -> BoundLinks:
    """Cut this rank's planar gauge blocks ``(4, Tl, Zl, gc, Y, Xh)`` into
    what every hop of ``part.overlap`` reads, exchanging the gauge's
    halos once if ``part.hoist_gauge``."""
    Tl, Zl = u_e.shape[1], u_e.shape[2]
    slabs = _slabs(Tl, Zl)
    extend = make_gauge_extender(part)

    def links(u):
        u = u.contiguous()
        ext = extend(u) if part.hoist_gauge else None
        inner = out_slabs = in_slabs = None
        if part.overlap == "interior" and Tl > 2 and Zl > 2:
            inner = _cut(u, 1, slice(1, -1), slice(1, -1))
        if part.overlap != "fused":
            out_slabs = tuple(_cut(u, 1, *o) for _, o, _ in slabs)
            if ext is not None:
                in_slabs = tuple(_cut(ext, 1, *s) for s, _, _ in slabs)
        return LocalLinks(u, ext, inner, out_slabs, in_slabs)

    stream = (torch.cuda.Stream(u_e.device)
              if u_e.device.type == "cuda" and part.overlap != "fused"
              else None)
    return BoundLinks(links(u_e), links(u_o), stream)


def _ext_hop(name: str, u_out, u_in_ext, src_ext, out_parity: int,
             origin, axpy=None):
    """One hopping block of the local stencil ``name`` on halo-extended
    ``src_ext`` / ``u_in_ext`` (``origin`` the output block's global
    ``(t0, z0)``), with the optional ``psi0 + coeff * hop`` epilogue."""
    if name == "cuda_hop":
        return ws.hop_block_planar(u_out, u_in_ext, src_ext, out_parity,
                                   tz_offset=origin, halo=True, axpy=axpy)
    if name == "torch_planar":
        return ref.hop_block_planar_ref(u_out, u_in_ext, src_ext,
                                        out_parity, tz_offset=origin,
                                        halo=True, axpy=axpy)
    off = (origin[0] + origin[1]) % 2

    def one(s):
        return ref.hop_block_ext_planar(u_out, u_in_ext, s, out_parity, off)
    out = one(src_ext) if src_ext.ndim == 5 else \
        torch.stack([one(s) for s in src_ext])
    return out if axpy is None else axpy[1] + axpy[0] * out


def _periodic_hop(name: str, u_out, u_in, src, out_parity: int, origin):
    """The periodic hop of ``split``'s bulk on the local block."""
    if name == "cuda_hop":
        return ws.hop_block_planar(u_out, u_in, src, out_parity,
                                   tz_offset=origin)
    if name == "torch_planar":
        return ref.hop_block_planar_ref(u_out, u_in, src, out_parity,
                                        tz_offset=origin)
    wrap = halo.TZGrid()      # one rank: extend_tz is the periodic wrap
    return _ext_hop(name, u_out, halo.extend_tz(u_in, wrap, 1, 2),
                    halo.extend_tz(src, wrap, 0, 1), out_parity, origin)


def _local_hop(part: QCDPartition, links: BoundLinks, src: torch.Tensor,
               out_parity: int, axpy=None) -> torch.Tensor:
    """One hopping block on this rank's block ``src`` (a leading ``nrhs``
    axis moves the whole batched face in one message per face): ``H_oe``
    (``out_parity`` 1) reads the odd links at the output and the even
    ones at the source.  ``axpy = (coeff, psi0)`` returns ``psi0 + coeff
    * hop``."""
    g_out, g_in = ((links.odd, links.even) if out_parity == evenodd.ODD
                   else (links.even, links.odd))
    lead = src.ndim - 5
    Tl, Zl = src.shape[lead], src.shape[lead + 1]
    part.check_block(Tl, Zl, batched=lead == 1)
    grid = part.grid
    t0, z0 = halo.local_origin(grid, Tl, Zl)
    name = part.stencil(src.device)
    if part.overlap == "fused":
        src_ext = halo.extend_tz(src, grid, lead, lead + 1)
        u_in_ext = g_in.ext if g_in.ext is not None else \
            halo.extend_tz(g_in.local, grid, 1, 2)
        return _ext_hop(name, g_out.local, u_in_ext, src_ext, out_parity,
                        (t0, z0), axpy)

    # interior / split: the faces go first; nothing up to wait() reads
    # them.
    pending = halo.start_exchange_tz(src, grid, lead, lead + 1,
                                     stream=links.stream)
    u_pending = None if g_in.ext is not None else halo.start_exchange_tz(
        g_in.local, grid, 1, 2, stream=links.stream)
    if part.overlap == "interior":
        out = torch.empty_like(src)
        out[(slice(None),) * lead + (slice(1, -1), slice(1, -1))] = _ext_hop(
            name, g_out.inner, g_in.local, src, out_parity,
            (t0 + 1, z0 + 1))
        # z-columns first: the t-rows own the corner sites.
        order = (2, 3, 0, 1)
    else:
        out = _periodic_hop(name, g_out.local, g_in.local, src, out_parity,
                            (t0, z0))
        order = (0, 1, 2, 3)
    src_ext = halo.assemble_tz(src, pending.wait(), lead, lead + 1)
    slabs = _slabs(Tl, Zl)
    if u_pending is None:
        in_slabs = g_in.in_slabs
    else:
        u_ext = halo.assemble_tz(g_in.local, u_pending.wait(), 1, 2)
        in_slabs = tuple(_cut(u_ext, 1, *s) for s, _, _ in slabs)
    for i in order:
        sl, o, (dt, dz) = slabs[i]
        out[(slice(None),) * lead + o] = _ext_hop(
            name, g_out.out_slabs[i], in_slabs[i], _cut(src_ext, lead, *sl),
            out_parity, (t0 + dt, z0 + dz))
    return out if axpy is None else axpy[1] + axpy[0] * out


def make_hop_fn(part: QCDPartition, out_parity: int):
    """``f(links, src) -> H src`` on this rank's block (``links`` from
    :func:`bind_links`); ``src`` may carry a leading ``nrhs`` axis."""
    def hop(links: BoundLinks, src):
        return _local_hop(part, links, src, out_parity)
    return hop


def make_dhat_fn(part: QCDPartition, kappa: float):
    """``f(links, psi_e) -> (1 - kappa^2 H_eo H_oe) psi_e`` on this rank's
    block; batch-polymorphic as :func:`make_hop_fn`.  The axpy rides in
    the second hop: in ``fused`` mode B1's epilogue computes it, as the
    two-launch ``Dhat`` of ``cuda_hop`` does."""
    coeff = -float(kappa) ** 2

    def dhat(links: BoundLinks, psi_e):
        tmp = _local_hop(part, links, psi_e, evenodd.ODD)
        return _local_hop(part, links, tmp, evenodd.EVEN,
                          axpy=(coeff, psi_e))
    return dhat


def make_dhat_dagger_fn(part: QCDPartition, kappa: float):
    """``Dhat^dag`` on this rank's block via gamma5-hermiticity (gamma5
    flips the sign of planar components 12..23)."""
    dhat = make_dhat_fn(part, kappa)

    def dagger(links: BoundLinks, psi_e):
        return layout.gamma5_planar(dhat(links, layout.gamma5_planar(psi_e)))
    return dagger

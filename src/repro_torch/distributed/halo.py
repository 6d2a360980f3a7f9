"""Halo exchange of the domain-decomposed lattice over ``torch.distributed``.

The lattice is split over t and z between the ranks of a process group,
laid out as a ``t_ranks x z_ranks`` grid (:class:`TZGrid`, rank ``r`` at
``divmod(r, z_ranks)``, lexicographic as the reference's mesh orders
its axes); x and y stay whole inside the packed ``(Y, Xh)`` plane, so
only t and z boundary planes ever cross ranks.

Each face goes in one message: a batched block ``(nrhs, Tl, Zl, 24, Y,
Xh)`` sends its whole ``nrhs``-wide face at once.  A single rank on an
axis is a local wrap (the reference's identity ``ppermute``): the face is
the rank's own opposite plane, and no send to self is issued.  The
transport follows the group's backend (:func:`transport`): NCCL sends
device buffers; gloo sends host tensors, so CUDA faces are staged
through pinned host buffers.

:func:`extend_tz` halo-extends an array to ``(Tl+2, Zl+2, ...)`` (t
faces, then z faces with the corners riding along);
:func:`start_exchange_tz` issues all four faces of the un-extended
array at once, optionally on a side CUDA stream, and its
:meth:`HaloExchange.wait` hands back :class:`HaloSlots` that
:func:`assemble_tz` turns into the extended array with zero corners
(the 8-point stencil never reads them).  :func:`group_sum` and
:func:`gather_tz` are the two collectives of a distributed solve: a
Krylov scalar summed over the group, and the rank blocks gathered into
the global field.  :func:`boundary_slab_index` is the index of one
boundary plane, which :func:`repro_torch.resilience.corrupt_halo_slab`
poisons.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels import counters
from ..kernels.layout import GAUGE_COMPS, SPINOR_COMPS

__all__ = ["TZGrid", "axis_index", "neighbor_plane", "extend_tz",
           "local_origin", "HaloSlots", "HaloExchange", "start_exchange_tz",
           "assemble_tz", "transport", "group_sum", "gather_tz",
           "boundary_slab_index", "halo_traffic_model"]

# Message tags of the four faces, so that two faces bound for the same
# neighbour (two ranks on an axis) cannot be confused.
_TAGS = {("t", +1): 0, ("t", -1): 1, ("z", +1): 2, ("z", -1): 3}


@dataclasses.dataclass(frozen=True)
class TZGrid:
    """A process group as a ``t_ranks x z_ranks`` grid; ``group=None`` is
    one rank with no ``torch.distributed`` group."""

    group: Optional[object] = None
    t_ranks: int = 1
    z_ranks: int = 1

    def __post_init__(self):
        world = 1 if self.group is None else dist.get_world_size(self.group)
        if self.t_ranks < 1 or self.z_ranks < 1 or \
                self.t_ranks * self.z_ranks != world:
            raise ValueError(
                f"a {self.t_ranks} x {self.z_ranks} grid of ranks does not "
                f"match the group's {world} rank(s)")

    @property
    def world(self) -> int:
        return self.t_ranks * self.z_ranks

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def size(self, axis: str) -> int:
        return self.t_ranks if axis == "t" else self.z_ranks

    def coords(self) -> Tuple[int, int]:
        """This rank's ``(t, z)`` place on the grid."""
        return divmod(self.rank, self.z_ranks)

    def neighbour(self, axis: str, step: int) -> int:
        """Group rank ``step`` places away along ``axis`` (periodic)."""
        it, iz = self.coords()
        if axis == "t":
            it = (it + step) % self.t_ranks
        else:
            iz = (iz + step) % self.z_ranks
        return it * self.z_ranks + iz


def axis_index(grid: TZGrid, axis: str) -> int:
    """This rank's index along ``axis`` (``"t"`` or ``"z"``)."""
    return grid.coords()[0 if axis == "t" else 1]


def local_origin(grid: TZGrid, t_local: int,
                 z_local: int) -> Tuple[int, int]:
    """Global ``(t0, z0)`` origin of this rank's block."""
    return (axis_index(grid, "t") * t_local, axis_index(grid, "z") * z_local)


def transport(grid: TZGrid, x: torch.Tensor) -> str:
    """How faces of ``x`` travel: ``"device"`` (NCCL, CUDA buffers),
    ``"host"`` (gloo with CUDA tensors, staged through pinned host
    buffers), ``"direct"`` (gloo with CPU tensors) or ``"fake"`` (a
    group of PyTorch's ``"fake"`` backend, the dry run's: no message is
    issued, each landing face is an uninitialised buffer of its shape);
    chosen from the group's backend."""
    backend = dist.get_backend(grid.group)
    if backend == "fake":
        return "fake"
    if backend == "nccl":
        if x.device.type != "cuda":
            raise ValueError("an NCCL group exchanges CUDA tensors only; "
                             f"got one on {x.device}")
        return "device"
    if backend == "gloo":
        return "host" if x.device.type == "cuda" else "direct"
    raise ValueError(f"no halo transport for a {backend!r} group; use "
                     "nccl, gloo or fake")


def _face(x: torch.Tensor, dim: int, direction: int) -> torch.Tensor:
    """The plane of ``x`` that fills a neighbour's halo: ``direction``
    +1 fills the neighbour above's lower halo with the last plane, -1
    the neighbour below's upper halo with the first plane."""
    n = x.shape[dim]
    return x.narrow(dim, n - 1, 1) if direction > 0 else x.narrow(dim, 0, 1)


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()


class HaloSlots(NamedTuple):
    """The four halo faces of one local array, from the un-extended
    array: the z faces carry no t-corner sites."""

    lo_t: torch.Tensor   # (1, Zl, ...)  from the t-1 neighbour
    hi_t: torch.Tensor   # (1, Zl, ...)  from the t+1 neighbour
    lo_z: torch.Tensor   # (Tl, 1, ...)  from the z-1 neighbour
    hi_z: torch.Tensor   # (Tl, 1, ...)  from the z+1 neighbour


class HaloExchange:
    """Faces of one array in flight; :meth:`wait` returns them.

    ``faces`` lists ``(axis, direction, dim)``: the halo below
    (``direction`` +1, the last plane of the rank below) or above (-1,
    the first plane of the rank above) along ``axis``, whose planes lie
    on dimension ``dim`` of ``x``.  With a ``stream`` (a side CUDA
    stream) the faces are packed there after the caller's stream has
    produced ``x``, NCCL's messages are queued behind them, and
    :meth:`wait` makes the caller's stream wait for the landed faces by
    a CUDA event, so the caller's kernels in between overlap the
    exchange.  Through host buffers (gloo with CUDA tensors) the
    messages go when the host reaches :meth:`wait`, after the caller has
    queued its kernels.
    """

    def __init__(self, grid: TZGrid, x: torch.Tensor, faces, *,
                 stream=None, result: Callable = list):
        self._result = result
        self._out: List[Optional[torch.Tensor]] = [None] * len(faces)
        self._works = None
        self._stream = stream
        self._caller = None
        self._packed = None
        self._ops = []        # (tensor, group peer, tag, is_send)
        self._landing = []    # (index, host buffer, device buffer)
        remote = [i for i, (axis, _, _) in enumerate(faces)
                  if grid.size(axis) > 1]
        for i, (axis, direction, dim) in enumerate(faces):
            if grid.size(axis) == 1:          # local wrap: no message
                self._out[i] = _face(x, dim, direction)
        if not remote:
            return
        self._grid = grid
        self._kind = transport(grid, x)
        if stream is not None:
            self._caller = torch.cuda.current_stream(x.device)
            stream.wait_stream(self._caller)
        with _on(stream):
            for i in remote:
                axis, direction, dim = faces[i]
                face = _face(x, dim, direction)
                counters.count_halo(face.numel() * face.element_size())
                tag = _TAGS[axis, direction]
                if self._kind == "host":
                    send = torch.empty(face.shape, dtype=x.dtype,
                                       pin_memory=True)
                    send.copy_(face, non_blocking=True)
                    recv = torch.empty(face.shape, dtype=x.dtype,
                                       pin_memory=True)
                    self._landing.append(
                        (i, recv, torch.empty(face.shape, dtype=x.dtype,
                                              device=x.device)))
                else:
                    send = face.contiguous()
                    recv = torch.empty_like(send)
                    self._out[i] = recv
                self._ops.append((send, grid.neighbour(axis, direction),
                                  tag, True))
                self._ops.append((recv, grid.neighbour(axis, -direction),
                                  tag, False))
            if self._kind == "fake":
                self._ops = []
            elif self._kind == "host":
                self._packed = torch.cuda.Event()
                self._packed.record()
            else:
                self._issue()

    def _issue(self):
        group = self._grid.group
        ops = [dist.P2POp(dist.isend if is_send else dist.irecv, t,
                          dist.get_global_rank(group, peer), group, tag)
               for t, peer, tag, is_send in self._ops]
        self._works = dist.batch_isend_irecv(ops)

    def wait(self):
        """The faces, landed; on CUDA the caller's stream is ordered
        after them."""
        if self._ops:
            if self._packed is not None:      # host staging: D2H done,
                self._packed.synchronize()    # then the messages go
                self._issue()
            with _on(self._stream):
                for w in self._works:
                    w.wait()
                for i, host, dev in self._landing:
                    dev.copy_(host, non_blocking=True)
                    self._out[i] = dev
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
                self._caller.wait_event(done)
            self._ops = []
        return self._result(self._out)


def neighbor_plane(x: torch.Tensor, grid: TZGrid, axis: str,
                   direction: int, dim: int) -> torch.Tensor:
    """The face plane from the neighbour along ``axis``: ``direction``
    +1 is the halo below (the last plane of the rank below), -1 the halo
    above (the first plane of the rank above)."""
    return HaloExchange(grid, x, [(axis, direction, dim)]).wait()[0]


def extend_tz(x: torch.Tensor, grid: TZGrid, t_axis: int = 0,
              z_axis: int = 1) -> torch.Tensor:
    """Halo-extend a local ``(Tl, Zl, ...)`` array to ``(Tl+2, Zl+2,
    ...)``: the t faces first, then the z faces of the t-extended array
    (corners ride along).  Contiguous."""
    lo, hi = HaloExchange(grid, x, [("t", +1, t_axis),
                                    ("t", -1, t_axis)]).wait()
    x = torch.cat([lo, x, hi], dim=t_axis)
    lo, hi = HaloExchange(grid, x, [("z", +1, z_axis),
                                    ("z", -1, z_axis)]).wait()
    return torch.cat([lo, x, hi], dim=z_axis)


def start_exchange_tz(x: torch.Tensor, grid: TZGrid, t_axis: int = 0,
                      z_axis: int = 1, *, stream=None) -> HaloExchange:
    """Issue all four faces of the un-extended ``x`` without assembling;
    ``wait()`` returns :class:`HaloSlots`.  Nothing the caller runs
    before ``wait()`` depends on them (see :class:`HaloExchange` for
    ``stream``)."""
    return HaloExchange(grid, x, [("t", +1, t_axis), ("t", -1, t_axis),
                                  ("z", +1, z_axis), ("z", -1, z_axis)],
                        stream=stream, result=HaloSlots._make)


def assemble_tz(x: torch.Tensor, slots: HaloSlots, t_axis: int = 0,
                z_axis: int = 1) -> torch.Tensor:
    """``(Tl+2, Zl+2, ...)`` from a local block and its slots, the four
    corner sites zero: equal to :func:`extend_tz` for every read of the
    8-point stencil, which never touches a diagonal neighbour."""
    ext_t = torch.cat([slots.lo_t, x, slots.hi_t], dim=t_axis)
    corner_shape = list(slots.lo_z.shape)
    corner_shape[t_axis] = 1
    corner = torch.zeros(corner_shape, dtype=x.dtype, device=x.device)
    lo_z = torch.cat([corner, slots.lo_z, corner], dim=t_axis)
    hi_z = torch.cat([corner, slots.hi_z, corner], dim=t_axis)
    return torch.cat([lo_z, ext_t, hi_z], dim=z_axis)


def _collective_tensor(grid: TZGrid, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's transport sends it (a host copy for gloo)."""
    return x.cpu() if transport(grid, x) == "host" else x.contiguous()


def group_sum(grid: TZGrid, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group's ranks (the same on every rank)."""
    if grid.world == 1:
        return x
    t = _collective_tensor(grid, x).clone()
    dist.all_reduce(t, group=grid.group)
    return t.to(x.device)


def gather_tz(grid: TZGrid, x: torch.Tensor, t_axis: int = 0) -> torch.Tensor:
    """Every rank's block ``x`` (``(Tl, Zl, ...)`` at ``t_axis``) gathered
    into the global ``(T, Z, ...)`` field on every rank, in one
    ``all_gather``."""
    if grid.world == 1:
        return x
    t = _collective_tensor(grid, x)
    parts = [torch.empty_like(t) for _ in range(grid.world)]
    dist.all_gather(parts, t, group=grid.group)
    z = grid.z_ranks
    rows = [torch.cat(parts[i * z:(i + 1) * z], dim=t_axis + 1)
            for i in range(grid.t_ranks)]
    return torch.cat(rows, dim=t_axis).to(x.device)


def boundary_slab_index(ndim: int, complex_layout: bool, axis: int = 0,
                        index: int = 0) -> Tuple:
    """Index tuple selecting one t/z boundary plane of an even-odd
    spinor field, the slab a halo exchange ships (``axis`` 0: t faces,
    1: z faces).

    Takes both vector layouts, with or without a leading nrhs axis:
    complex ``(T, Z, Y, Xh, 4, 3)`` and planar ``(T, Z, 24, Y, Xh)``.
    """
    base = 6 if complex_layout else 5
    if ndim not in (base, base + 1):
        raise ValueError(
            f"unrecognized spinor layout: ndim={ndim} for "
            f"{'complex' if complex_layout else 'planar'} data")
    if axis not in (0, 1):
        raise ValueError("axis must be 0 (t faces) or 1 (z faces)")
    idx: list = [slice(None)] * ndim
    idx[(ndim - base) + axis] = index
    return tuple(idx)


def halo_traffic_model(Tl: int, Zl: int, Y: int, Xh: int, *,
                       nrhs: int = 1, itemsize: int = 4,
                       gauge_comps: int = GAUGE_COMPS) -> dict:
    """Per-rank interconnect bytes of one hopping-block halo exchange.

    ``extend_tz`` moves 2 t-faces of ``Zl`` planes and 2 z-faces of
    ``Tl + 2`` planes (corners ride along); the slot-based overlap path
    moves the same faces minus the 4 corner rows, so the model (the
    ``extend_tz`` count) is an upper bound either way.  Spinor faces
    scale with ``nrhs``; gauge faces with ``gauge_comps``: compressed
    links are shipped compressed.  A ``Dhat`` runs two hopping blocks:
    double everything for the operator.
    """
    face_sites = (2 * Zl + 2 * (Tl + 2)) * Y * Xh
    bytes_spinor = itemsize * nrhs * SPINOR_COMPS * face_sites
    bytes_gauge = itemsize * 4 * gauge_comps * face_sites
    return {
        "face_sites": face_sites,
        "bytes_spinor_exchange": bytes_spinor,
        "bytes_gauge_exchange": bytes_gauge,
        "bytes_hop_exchange": bytes_spinor + bytes_gauge,
        "bytes_dhat_exchange": 2 * (bytes_spinor + bytes_gauge),
    }

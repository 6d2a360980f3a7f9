"""Device meshes for the production dry run and elastic re-meshing, as
``torch.distributed`` ``DeviceMesh``es over the ranks of the default
process group.

All constructors are functions (never module-level constants), so that
importing this module touches no process group.  A mesh larger than the
group raises, as the reference's does with too few devices.

:func:`fake_world` sets up a process group of the ``"fake"`` backend
(PyTorch's ``torch.testing._internal.distributed.fake_pg``, a private
module: every collective completes at once and moves nothing), on which
one process plays rank 0 of a world of 256 or 512 ranks: the dry run
traces a production mesh on it, as the reference lowers for 512 forced
host devices.  It is the one place the fake backend is imported.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["grid_mesh", "make_production_mesh", "elastic_shape",
           "elastic_mesh", "dp_axes", "axis_size", "fake_world",
           "mesh_device_type"]


def mesh_device_type() -> str:
    """``cuda`` where PyTorch sees a GPU, else ``cpu``: the device type of
    a mesh and of the dry run's fake tensors."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def grid_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` over ``names`` on the group's first
    ``prod(shape)`` ranks; raises if the group has fewer."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world}; run under "
            "torchrun with that many processes, or inside "
            "launch.mesh.fake_world(512) for the dry run")
    return DeviceMesh(device_type or mesh_device_type(),
                      torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 single pod (256 ranks) over ``("data", "model")`` or 2x16x16
    multi-pod (512 ranks) over ``("pod", "data", "model")``.

    Uses the first ``prod(shape)`` ranks, so the single-pod mesh also
    works in a 512-rank dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return grid_mesh(shape, axes, device_type)


def elastic_shape(n: int, max_model: int = 16) -> Tuple[int, int]:
    """``(data, model)`` for ``n`` ranks: the largest power of two <=
    ``max_model`` that divides ``n`` on ``model``, the rest on
    ``data``."""
    model = 1
    while model * 2 <= max_model and n % (model * 2) == 0:
        model *= 2
    return n // model, model


def elastic_mesh(n_devices: Optional[int] = None, max_model: int = 16,
                 device_type: Optional[str] = None):
    """Re-derive a legal ``(data, model)`` mesh from a surviving rank
    count (default: the whole group; one rank degrades to ``(1, 1)``)."""
    n = n_devices if n_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return grid_mesh(elastic_shape(n, max_model), ("data", "model"),
                     device_type)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (``pod`` and ``data``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    """The number of ranks along one axis name or a tuple of them."""
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A default process group of the ``"fake"`` backend with ``n`` ranks,
    this process rank 0, for the life of the context.  Raises if a
    default group exists already, or if this PyTorch lacks the fake
    backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:        # pragma: no cover - version guard
        raise RuntimeError(
            "the dry run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            f"which this PyTorch {torch.__version__} lacks") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists "
                           "already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()

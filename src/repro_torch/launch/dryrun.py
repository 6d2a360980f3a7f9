"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
on a fake process group and record memory / flop / collective statistics.

This is the proof that the distribution config is coherent: a placement
that DTensor cannot carry through an op, or an op with no rule, fails
the cell.  No card is needed and nothing is allocated: one process plays
rank 0 of a 512-rank group of PyTorch's ``"fake"`` backend
(:func:`repro_torch.launch.mesh.fake_world`), the parameters, optimizer
moments, batches and caches are DTensors over fake tensors (a
``FakeTensorMode``) placed by :class:`~.sharding.ShardingPolicy`, and the
port's own train / prefill / decode steps run on them.

Where the reference lowers and compiles with XLA and reads its cost and
memory analyses and the HLO text, each record here comes from counting
modes around the traced step, on the local shards (the global figures
DTensor ops would give are divided by nothing):

* ``flops_per_device``: the matmul-class flops of
  ``torch.utils.flop_counter`` (its registry, applied to every aten op
  this rank runs on its shard);
* ``bytes_accessed_per_device``: the input and output bytes of every
  aten op this rank runs (views move nothing and count nothing),
  XLA's convention;
* ``arg_/out_/temp_/peak_/fit_bytes_per_device``: the step's arguments
  and results, summed over their local shards, and the peak of
  ``torch.distributed._tools.mem_tracker.MemTracker`` (a private API)
  over the step; ``temp`` is what the peak holds beyond both;
* ``collectives``: bytes by kind (each functional collective's result
  shape, as the reference reads it) and, from ``CommDebugMode``, the
  count of each;
* ``trace_s`` in place of ``lower_s`` and ``compile_s``.

The reference also runs small unrolled probes (``_probe_cfg``,
``probe_lm``, ``scan_aware_collectives``) because XLA's cost analysis
counts a while-loop body once; the port runs its layers and
microbatches as Python loops, so the counts above see every layer, and
the records' ``exact`` block (``flops``, ``bytes``, ``coll``,
``coll_by_kind``) is filled from them directly.

QCD cells apply the distributed ``Dhat`` of
:mod:`repro_torch.distributed.qcd` to fake blocks, T over ``pod`` x
``data`` and Z over ``model``, on the plain local stencils (the CUDA
kernels are calls on data pointers and cannot take fake tensors; the
reference traces its ``jnp`` stencils, not Pallas); their collectives
are the halo counter's bytes and messages (``kernels/counters.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --qcd-only
Results land in experiments/torch_dryrun/<cell>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..distributed import qcd as qcd_lib
from ..kernels import counters
from ..models import layers as layers_lib
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..models.config import ModelConfig
from ..optim import adamw
from . import mesh as mesh_lib
from . import specs as specs_lib
from .sharding import ShardingPolicy, distribute, local_shape, placements

__all__ = ["run_lm_cell", "run_qcd_cell", "model_flops", "qcd_model_flops",
           "StepCounter", "main"]

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "torch_dryrun")
WORLD = 512
PREFILL_KV_CHUNK = 256       # the reference's prefill kv chunk

# functional collectives (the ops DTensor issues) -> the reference's kinds
_COLL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if layers_lib.is_dtensor(t) else t


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _propagating() -> bool:
    """Whether DTensor's sharding propagator is running an op on global
    shapes to find its output's metadata (not this rank's work)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def _check_propagator() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError(
            "the dry run's counters skip DTensor's global-shape metadata "
            "pass by its name, ShardingPropagator."
            "_propagate_tensor_meta_non_cached, which this PyTorch "
            f"{torch.__version__} lacks")


class StepCounter(TorchDispatchMode):
    """Counts, on the local shards, the flops, bytes and collectives of
    every aten op this rank runs inside the context.  Ops on DTensors are
    handed on (``NotImplemented``): DTensor runs them as ops on local
    shards, which come back here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_by_kind: Dict[str, int] = {}
        self.n_coll = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _propagating():
            return out
        packet = func.overloadpacket
        kind = _COLL_KINDS.get(packet.__name__)
        if kind is not None and func.namespace in ("_c10d_functional",
                                                  "_dtensor"):
            self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0) + \
                sum(_nbytes(t) for t in _tensors(out))
            self.n_coll += 1
            return out
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in _tensors(kwargs)) + \
                sum(_nbytes(t) for t in _tensors(out))
        return out


def _mem_tracker():
    """A ``MemTracker`` that leaves DTensor's metadata pass untracked: it
    runs under the dry run's own fake mode, with global shapes, where
    the tracker's own test for it (a fake mode other than its entry's)
    does not see it."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as e:        # pragma: no cover - version guard
        raise RuntimeError(
            "the dry run's memory figures need PyTorch's private "
            "torch.distributed._tools.mem_tracker.MemTracker, which this "
            f"PyTorch {torch.__version__} lacks") from e

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _comm_debug_mode():
    from torch.distributed.tensor.debug import CommDebugMode
    return CommDebugMode()


@dataclasses.dataclass
class Traced:
    """What one counted run of a step saw."""

    seconds: float
    counter: StepCounter
    peak: int
    comm_counts: Dict[str, int]
    result: Any


def trace(fn, mode, tracked=()) -> Traced:
    """Run ``fn()`` once under the fake mode ``mode`` inside the
    counters, ``tracked`` (tensors made before) registered with the
    memory tracker (which sees fake tensors only when entered inside
    their mode)."""
    _check_propagator()
    mt = _mem_tracker()
    if tracked:
        mt.track_external(*tracked)
    comm = _comm_debug_mode()
    counter = StepCounter()
    t0 = time.perf_counter()
    with mode, mt, comm, counter:
        result = fn()
    seconds = time.perf_counter() - t0
    peak = sum(d.get("Total", sum(d.values()))
               for d in mt.get_tracker_snapshot("peak").values())
    counts = {str(k).split(".")[-1]: int(v)
              for k, v in comm.get_comm_counts().items()}
    return Traced(seconds, counter, int(peak), counts, result)


def _record(name: str, tr: Traced, n_devices: int, args, outs,
            collectives: Optional[Dict[str, Any]] = None,
            **extra) -> Dict[str, Any]:
    c = tr.counter
    arg_b, out_b = local_bytes(args), local_bytes(outs)
    if collectives is None:
        collectives = {"bytes_by_kind": dict(c.coll_by_kind),
                       "total_bytes": sum(c.coll_by_kind.values()),
                       "n_ops": c.n_coll, "ops_by_kind": tr.comm_counts}
    temp = max(0, tr.peak - arg_b - out_b)
    return {
        "cell": name,
        "status": "ok",
        "n_devices": n_devices,
        "trace_s": round(tr.seconds, 2),
        "flops_per_device": float(c.flops),
        "bytes_accessed_per_device": float(c.bytes),
        "arg_bytes_per_device": int(arg_b),
        "out_bytes_per_device": int(out_b),
        "temp_bytes_per_device": int(temp),
        "peak_bytes_per_device": int(tr.peak),
        "fit_bytes_per_device": int(arg_b + out_b + temp),
        "collectives": collectives,
        "exact": {"flops": float(c.flops), "bytes": float(c.bytes),
                  "coll": float(collectives["total_bytes"]),
                  "coll_by_kind": dict(collectives["bytes_by_kind"])},
        **extra,
    }


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _accum_steps(policy: ShardingPolicy, global_batch: int,
                 target_local: int = 4) -> int:
    dp = 1
    for a in policy.batch_spec(global_batch):
        dp *= mesh_lib.axis_size(policy.mesh, a)
    local = max(1, global_batch // dp)
    accum = max(1, local // target_local)
    while global_batch % (accum * dp) != 0 and accum > 1:
        accum -= 1
    return accum


def _attn_constraint(cfg: ModelConfig, policy: ShardingPolicy, mesh,
                     batch: int):
    """Head-parallel attention pin: q/out (B,S,H,hd) shard H over model,
    k/v (B,S,K,hd) shard K when divisible.

    Decode special case: when the KV cache is hd-sharded (K % tp != 0),
    q/out shard hd instead, which keeps the cache resident."""
    msize = mesh_lib.axis_size(mesh, "model")
    b = policy.batch_spec(batch)
    kv_mismatch = cfg.n_kv_heads % msize != 0

    def fn(x, kind):
        if x.ndim != 4 or not layers_lib.is_dtensor(x):
            return x
        S, heads, hd = x.shape[1], x.shape[2], x.shape[3]
        decode = S == 1
        if decode and kv_mismatch and hd % msize == 0 and hd >= msize:
            spec = (b, None, None, "model")
        elif heads % msize == 0 and heads >= msize:
            spec = (b, None, "model", None)
        elif kind == "q" and hd % msize == 0 and hd >= msize:
            spec = (b, None, None, "model")
        else:
            return x
        return x.redistribute(mesh, placements(mesh, spec))

    return fn


def _placed(mesh, spec, like: torch.Tensor, dtype=None):
    """A DTensor of ``like``'s shape (and dtype, or ``dtype``) placed by
    ``spec``, from a fresh local shard (call under the fake mode)."""
    local = torch.empty(local_shape(mesh, spec, like.shape),
                        dtype=dtype or like.dtype, device=like.device)
    return distribute(mesh, spec, local, like.shape)


def _place_tree(mesh, tree, specs: Dict[str, Any], mode, *, dtype=None,
                requires_grad=False):
    """A tree of DTensors shaped as ``tree`` (dotted names as
    ``model.flatten``), placed by ``specs``; ``dtype`` replaces f32."""
    placed = {}
    with mode:
        for name, t in model_lib.flatten(tree).items():
            d = _placed(mesh, specs[name], t, dtype if dtype is not None
                        and t.dtype == torch.float32 else None)
            placed[name] = d.requires_grad_(True) if requires_grad else d
    return model_lib.unflatten(tree, placed), placed


class _Held:
    """The ``model`` a train step takes: a holder of a parameter tree."""

    def __init__(self, tree):
        self._tree = tree

    def params(self):
        return self._tree


def _ctx(attn_fn):
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(layers_lib.attention_constraint(attn_fn))
    return stack


def _place_batch(mesh, policy, batch, mode):
    bspecs = policy.data_spec(batch)
    with mode:
        return {k: _placed(mesh, bspecs[k], v) for k, v in batch.items()}


def _place_cache(mesh, policy, cfg, cache, mode):
    """The cache (one dict per layer) as DTensors placed by the policy's
    cache specs."""
    with mode:
        return [{k: _placed(mesh, lspec[k], t) for k, t in layer.items()}
                for layer, lspec in zip(cache,
                                        policy.cache_specs(cfg, cache))]


def run_lm_cell(name: str, cfg: ModelConfig, cell, mesh, *,
                seq_shard: bool = True,
                accum: Optional[int] = None) -> Dict[str, Any]:
    """Trace one LM cell (train, prefill or decode) on ``mesh`` and
    return its record (``opt_level=1`` of the reference: per-shard MoE
    routing, no vocab FSDP, bf16 weight-resident decode).  The fake
    tensors claim the mesh's device type."""
    device = mesh.device_type
    mode = specs_lib.fake_mode()
    n_dev = mesh.size()
    fsdp_axis = "data"
    serve_dtype = None
    if cfg.moe and cell.kind in ("train", "prefill"):
        cfg = cfg.scaled(route_groups=mesh_lib.axis_size(
            mesh, mesh_lib.dp_axes(mesh)))
    if cell.kind == "decode":
        # weight-resident serving: bf16 params, TP-only when they fit
        serve_dtype = torch.bfloat16
        if cfg.param_count() * 2 / mesh_lib.axis_size(mesh, "model") \
                < 12e9:
            fsdp_axis = None
    policy = ShardingPolicy(mesh, seq_shard_activations=seq_shard,
                            fsdp_axis=fsdp_axis)
    shapes = specs_lib.params_shapes(cfg, mode=mode, device=device)
    pspecs = policy.param_specs(shapes)
    attn_fn = _attn_constraint(cfg, policy, mesh, cell.global_batch)
    meta = dict(model_flops_global=model_flops(cfg, cell), kind=cell.kind,
                shape=cell.name)

    if cell.kind == "train":
        tree, flat = _place_tree(mesh, shapes, pspecs, mode,
                                 requires_grad=True)
        leaves = list(flat.values())
        # AdamW's moments: f32, placed as the (f32) parameters
        _, m = _place_tree(mesh, shapes, pspecs, mode)
        _, v = _place_tree(mesh, shapes, pspecs, mode)
        with mode:
            count = torch.zeros((), dtype=torch.int32, device=device)
        state = adamw.OptState(list(m.values()), list(v.values()), count)
        batch = _place_batch(mesh, policy, specs_lib.batch_specs(
            cfg, cell.global_batch, cell.seq_len, mode=mode, device=device),
            mode)
        # bigger models get smaller microbatches (activation memory)
        target = 1 if cfg.param_count() > 2e10 else 4
        a = accum if accum is not None else _accum_steps(
            policy, cell.global_batch, target_local=target)
        act = placements(mesh, policy.activation_spec(
            cell.global_batch // a, cell.seq_len))
        gpl = [placements(mesh, pspecs[n]) for n in flat]

        def constraint(x):
            return x.redistribute(mesh, act) \
                if layers_lib.is_dtensor(x) else x

        def grad_constraint(grads):
            return [g.redistribute(mesh, p) for g, p in zip(grads, gpl)]

        step = steps_lib.make_train_step(
            cfg, adamw.AdamW(), remat=True, accum_steps=a,
            constraint_fn=constraint, grad_constraint_fn=grad_constraint)

        def run():
            with _ctx(attn_fn):
                return step(_Held(tree), state, batch, 0)

        args = (leaves, state, batch)
        tr = trace(run, mode, tracked=tuple(leaves) + tuple(state.m)
                   + tuple(state.v) + tuple(batch.values()))
        return _record(name, tr, n_dev, args, tr.result[1], accum=a,
                       **meta)

    if cell.kind == "prefill":
        tree, flat = _place_tree(mesh, shapes, pspecs, mode)
        batch = _place_batch(mesh, policy, specs_lib.batch_specs(
            cfg, cell.global_batch, cell.seq_len, mode=mode, device=device),
            mode)
        cache = _place_cache(mesh, policy, cfg, specs_lib.cache_shapes(
            cfg, cell.global_batch, cell.seq_len, mode=mode, device=device),
            mode)
        fn = steps_lib.make_prefill_step(cfg, cell.seq_len,
                                         kv_chunk=PREFILL_KV_CHUNK)

        def run():
            with _ctx(attn_fn), torch.no_grad():
                return fn(tree, batch, cache)

        tr = trace(run, mode, tracked=tuple(flat.values())
                   + tuple(batch.values()) + tuple(_tensors(cache)))
        return _record(name, tr, n_dev, (tree, batch, cache),
                       tr.result[0], **meta)

    # decode: bf16 weights, a full cache, one token per sequence
    tree, flat = _place_tree(mesh, shapes, pspecs, mode, dtype=serve_dtype)
    cache, tokens, index = specs_lib.decode_specs(cfg, cell, mode=mode,
                                                  device=device)
    dcache = _place_cache(mesh, policy, cfg, cache, mode)
    with mode:
        dtok = _placed(mesh, (policy.batch_spec(cell.global_batch), None),
                       tokens)
    fn = steps_lib.make_serve_step(cfg)

    def run():
        with _ctx(attn_fn), torch.no_grad():
            return fn(tree, dcache, dtok, index)

    tr = trace(run, mode, tracked=tuple(flat.values())
               + tuple(t for layer in dcache for t in layer.values())
               + (dtok,))
    return _record(name, tr, n_dev, (tree, dcache, dtok), tr.result[:2],
                   **meta)


def model_flops(cfg: ModelConfig, cell) -> float:
    n_active = cfg.param_count(active_only=True)
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # decode: one token


# ---------------------------------------------------------------------------
# QCD cells (the paper's own operator on the production mesh)
# ---------------------------------------------------------------------------

QCD_VARIANTS = {
    "fused": dict(backend="torch_ref", overlap="fused"),
    "split": dict(backend="torch_ref", overlap="split"),
    "planar": dict(backend="torch_planar"),
    "opt": dict(backend="torch_planar", hoist_gauge=True),
    "opt-bf16": dict(backend="torch_planar", hoist_gauge=True,
                     dtype=torch.bfloat16),
}


def qcd_grid(mesh_shape: Dict[str, int]):
    """``(t_ranks, z_ranks)``: T over ``pod`` x ``data``, Z over
    ``model``."""
    t = 1
    for a in ("pod", "data"):
        t *= mesh_shape.get(a, 1)
    return t, mesh_shape["model"]


def qcd_skip(lat, t_ranks: int, z_ranks: int, overlap: str
             ) -> Optional[str]:
    """The reference's reason to skip a QCD cell, or ``None``."""
    T, Z = lat.shape[0], lat.shape[1]
    if T % t_ranks or Z % z_ranks:
        return (f"lattice T={T},Z={Z} not divisible by mesh shards "
                f"({t_ranks},{z_ranks}); paper volumes are per-node, run "
                "them on smaller meshes")
    if overlap == "split" and (T // t_ranks < 2 or Z // z_ranks < 2):
        return "split overlap needs local T,Z >= 2"
    return None


def run_qcd_cell(name: str, lat, group, t_ranks: int, z_ranks: int, *,
                 backend: str = "torch_ref", overlap: str = "fused",
                 hoist_gauge: bool = False,
                 dtype=torch.float32) -> Dict[str, Any]:
    """Trace one distributed ``Dhat`` on this rank's fake block of
    ``lat`` over ``group`` (a ``t_ranks x z_ranks`` grid) and return its
    record; collectives are the halo counter's, for the ``Dhat`` alone
    (a hoisted gauge's exchange at bind is not counted)."""
    part = qcd_lib.QCDPartition(group=group, t_ranks=t_ranks,
                                z_ranks=z_ranks, backend=backend,
                                overlap=overlap, hoist_gauge=hoist_gauge)
    T, Z, Y, X = lat.shape
    Tl, Zl = part.local_extents(T, Z)
    mode = specs_lib.fake_mode()
    device = "cpu"          # the blocks' device changes no count
    with mode:
        u_e, u_o = (torch.empty((4, Tl, Zl, 18, Y, X // 2), dtype=dtype,
                                device=device) for _ in range(2))
        psi = torch.empty((Tl, Zl, 24, Y, X // 2), dtype=dtype,
                          device=device)
        links = qcd_lib.bind_links(part, u_e, u_o)
    # The dry run traces fake blocks, so there is no gauge to bind a
    # registry backend to.
    # repro-torch-lint: allow[TR2] the dry run needs the raw sharded dhat
    dhat = qcd_lib.make_dhat_fn(part, lat.kappa)
    counters.reset_halo_counts()

    args = (links.even.local, links.odd.local, psi) if not hoist_gauge \
        else (links.even.ext, links.odd.ext, psi)
    tr = trace(lambda: dhat(links, psi), mode, tracked=args)
    sent = dict(counters.HALO)
    coll = {"bytes_by_kind": {"collective-permute": sent["bytes"]},
            "total_bytes": sent["bytes"], "n_ops": sent["messages"],
            "ops_by_kind": {"collective-permute": sent["messages"]}}
    return _record(name, tr, t_ranks * z_ranks, args, tr.result,
                   collectives=coll, model_flops_global=qcd_model_flops(lat),
                   kind="qcd", shape=name.split("__")[1])


def qcd_model_flops(lat) -> float:
    T, Z, Y, X = lat.shape
    V = T * Z * Y * X
    return 1320.0 * V + 24.0 * V / 2  # two eo hop blocks + fused axpy


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

_MESHES = {"single": {"data": 16, "model": 16},
           "multi": {"pod": 2, "data": 16, "model": 16}}


def _fail(name: str, e: BaseException) -> Dict[str, Any]:
    return {"cell": name, "status": "fail",
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Trace every (architecture x shape x mesh) cell and the "
                    "QCD Dhat on a fake 512-rank process group.")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or comma list")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--qcd", action="store_true", default=True)
    ap.add_argument("--no-qcd", dest="qcd", action="store_false")
    ap.add_argument("--qcd-only", action="store_true")
    ap.add_argument("--lm-seq-shard", type=int, default=1)
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": False, "multi": True}
    if args.mesh != "both":
        meshes = {args.mesh: meshes[args.mesh]}

    results = []

    def record(rec, fname):
        results.append(rec)
        (out_dir / fname).write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ("" if status != "ok" else
                 f" flops/dev={rec['flops_per_device']:.3e}"
                 f" fit={rec['fit_bytes_per_device']/2**30:.2f}GiB"
                 f" coll={rec['collectives']['total_bytes']/2**20:.1f}MiB"
                 f" trace={rec['trace_s']:.1f}s")
        print(f"[{status:>4s}] {rec['cell']}{extra}", flush=True)

    with mesh_lib.fake_world(WORLD):
        groups = {}
        if not args.qcd_only:
            arch_list = (list(configs.ARCH_NAMES) if args.arch == "all"
                         else args.arch.split(","))
            for arch in arch_list:
                cfg = configs.get(arch)
                for cell, skip in configs.shapes_for(cfg):
                    if args.shape != "all" and cell.name not in \
                            args.shape.split(","):
                        continue
                    for mname, multi in meshes.items():
                        cname = f"{arch}__{cell.name}__{mname}"
                        fname = f"{cname.replace('/', '_')}.json"
                        if skip:
                            record({"cell": cname, "status": "skip",
                                    "reason": skip}, fname)
                            continue
                        try:
                            mesh = mesh_lib.make_production_mesh(
                                multi_pod=multi)
                            rec = run_lm_cell(
                                cname, cfg, cell, mesh,
                                seq_shard=bool(args.lm_seq_shard))
                            rec.update(arch=arch, mesh=mname)
                        except Exception as e:  # noqa: BLE001
                            rec = _fail(cname, e)
                        record(rec, fname)

        if args.qcd or args.qcd_only:
            lats = (("wilson-production",) if not args.qcd_only
                    else tuple(configs.QCD_CONFIGS))
            for lat_name in lats:
                lat = configs.get_qcd(lat_name)
                for mname in meshes:
                    t_ranks, z_ranks = qcd_grid(_MESHES[mname])
                    n = t_ranks * z_ranks
                    for variant, vkw in QCD_VARIANTS.items():
                        cname = f"{lat_name}__dhat-{variant}__{mname}"
                        fname = f"{cname}.json"
                        skip = qcd_skip(lat, t_ranks, z_ranks,
                                        vkw.get("overlap", "fused"))
                        if skip:
                            record({"cell": cname, "status": "skip",
                                    "reason": skip}, fname)
                            continue
                        try:
                            if n not in groups:
                                groups[n] = torch.distributed.new_group(
                                    list(range(n)))
                            rec = run_qcd_cell(cname, lat, groups[n],
                                               t_ranks, z_ranks, **vkw)
                            rec.update(arch=lat_name, mesh=mname)
                        except Exception as e:  # noqa: BLE001
                            rec = _fail(cname, e)
                        record(rec, fname)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"of {len(results)} cells")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

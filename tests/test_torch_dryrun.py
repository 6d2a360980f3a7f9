"""The port's multi-device layer (``repro_torch.launch.{mesh, sharding,
specs, dryrun, roofline}``) against the reference, on the CPU.

* Sharding: every parameter, cache, batch, data and activation spec of
  all ten architectures on both production meshes equals the
  reference's ``ShardingPolicy`` with its stack dims dropped (the port
  keeps layers as a list).  The reference's policy reads only the
  mesh's shape and axis names, so it gets a ``jax.sharding.AbstractMesh``;
  its shapes come from ``repro.launch.specs`` (``eval_shape``).  The
  port's meshes are ``DeviceMesh``es on a fake process group of 512
  ranks.
* Meshes and specs: ``elastic_mesh`` shapes, the fake inputs' shapes and
  dtypes, ``model_flops`` and ``qcd_model_flops``.
* QCD cells: every cell of three lattices on the single mesh is ``ok``
  or the reference's ``skip``; the collective bytes per ``Dhat`` of
  ``fused``, ``planar`` and ``opt`` equal the reference's dry run
  (figures measured there) and ``halo_traffic_model``; ``split`` and
  ``opt-bf16`` are the port's own figures, pinned with their reasons.
* One small LM train cell on the 256-rank mesh, and the H100 roofline on
  fixed records.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as rconfigs
from repro.distributed import halo as jhalo
from repro.launch import mesh as rmesh
from repro.launch import sharding as rsharding
from repro.launch import specs as rspecs
from repro_torch import configs
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun, mesh, roofline, sharding, specs
from repro_torch.models import model as model_lib
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# Per-device collective bytes of one Dhat in the reference's dry run
# (``python -m repro.launch.dryrun --qcd-only --mesh single``, 16 x 16).
REF_QCD_BYTES = {
    "wilson-16x16x16x16": {"fused": 786432, "planar": 786432,
                           "opt": 196608},
    "wilson-64x16x16x8": {"fused": 3145728, "planar": 3145728,
                          "opt": 786432},
    "wilson-64x32x32x16": {"fused": 9437184, "planar": 9437184,
                           "opt": 2359296},
}


@pytest.fixture(scope="module")
def rdryrun():
    """``repro.launch.dryrun``, imported so that what its import writes
    into ``os.environ`` for its own process (512 forced host devices,
    the TPU-faithful dot) does not outlive the import: the other tests
    of this worker, and the subprocesses they start, read both."""
    jax.devices()          # the backend starts with this process's flags
    saved = dict(os.environ)
    try:
        from repro.launch import dryrun
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return dryrun


@pytest.fixture(scope="module")
def world():
    with mesh.fake_world(512):
        yield {name: mesh.make_production_mesh(multi_pod=name == "multi")
               for name in MESHES}


def _ref_policy(name, **kw):
    shape, axes = MESHES[name]
    return rsharding.ShardingPolicy(AbstractMesh(shape, axes), **kw)


def _ref_flat(tree):
    """Dotted path -> leaf of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        out[".".join(rsharding._key_name(k) for k in path)] = leaf
    return out


def _canon(spec):
    """A spec with each entry in one form: ``None`` for no axes, a name
    for one, a tuple for several (``PartitionSpec`` reads ``("data",)``
    as ``"data"`` and ``()`` as ``None``)."""
    def one(e):
        if isinstance(e, (tuple, list)):
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in spec)


def _ref_name(port_name):
    """The reference's path of a port leaf: ``layers.<group>.<member>``
    is ``layers.<member>`` stacked over groups."""
    parts = port_name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        return ".".join([parts[0]] + parts[2:]), 1
    return port_name, 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_equal_reference(world, mesh_name, arch):
    rcfg = rconfigs.get(arch)
    want = _ref_flat(_ref_policy(mesh_name).param_specs(
        rspecs.params_shapes(rcfg)))
    pol = sharding.ShardingPolicy(world[mesh_name])
    got = pol.param_specs(specs.params_shapes(configs.get(arch)))
    assert len(got) >= len(want)
    for name, spec in got.items():
        ref, stack = _ref_name(name)
        assert _canon(spec) == _canon(tuple(want[ref])[stack:]), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_batch_activation_specs_equal_reference(world, mesh_name,
                                                      arch):
    rcfg, cfg = rconfigs.get(arch), configs.get(arch)
    rpol = _ref_policy(mesh_name)
    pol = sharding.ShardingPolicy(world[mesh_name])
    for batch, length in ((128, 1024), (1, 768), (32, 2048)):
        if cfg.supports_decode:
            rcache = rspecs.cache_shapes(rcfg, batch, length)
            want = _ref_flat(rpol.cache_specs(rcfg, rcache))
            cache = specs.cache_shapes(cfg, batch, length)
            got = pol.cache_specs(cfg, cache)
            assert len(got) == cfg.n_layers
            for layer in got:
                assert set(layer) == set(want)
                for k, spec in layer.items():
                    assert _canon(spec) == _canon(tuple(want[k])[1:]), \
                        (k, batch)
        rbatch = rspecs.batch_specs(rcfg, batch, length)
        fbatch = specs.batch_specs(cfg, batch, length)
        assert {k: _canon(v) for k, v in pol.data_spec(fbatch).items()} \
            == {k: _canon(v) for k, v in rpol.data_spec(rbatch).items()}
        assert pol.batch_spec(batch) == rpol.batch_spec(batch)
        for seq_shard in (True, False):
            a = sharding.ShardingPolicy(world[mesh_name],
                                        seq_shard_activations=seq_shard)
            b = _ref_policy(mesh_name, seq_shard_activations=seq_shard)
            assert _canon(a.activation_spec(batch, length)) == \
                _canon(b.activation_spec(batch, length))


def test_placements_follow_specs(world):
    from torch.distributed.tensor import Replicate, Shard

    m = world["multi"]
    assert sharding.placements(m, (("pod", "data"), "model", None)) == \
        [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements(m, (None, None)) == [Replicate()] * 3
    full = torch.arange(1024.0).reshape(32, 32)
    # rank 0 holds the first slice of every sharded dim
    spec = (("pod", "data"), "model")
    assert torch.equal(sharding.shard_of(full, m, spec), full[:1, :2])
    d = sharding.place(full, m, spec)
    assert tuple(d.shape) == (32, 32) and tuple(d.to_local().shape) == (1, 2)
    assert sharding.local_shape(m, spec, (32, 32)) == (1, 2)


def test_elastic_mesh_shapes_equal_reference(world, monkeypatch):
    monkeypatch.setattr(rmesh.jax, "devices", lambda: list(range(256)))
    monkeypatch.setattr(rmesh, "Mesh", lambda arr, axes: (arr.shape, axes))
    for n in (1, 2, 6, 8, 12, 16, 256):
        want = rmesh.elastic_mesh(n)
        assert mesh.elastic_shape(n) == want[0], n
        m = mesh.elastic_mesh(n)
        assert (tuple(m.shape), m.mesh_dim_names) == want, n
    assert mesh.dp_axes(world["multi"]) == ("pod", "data")
    assert mesh.axis_size(world["multi"], ("pod", "data")) == 32


def test_mesh_larger_than_group_raises(world):
    with pytest.raises(RuntimeError, match="need 1024 ranks"):
        mesh.elastic_mesh(1024)
    with pytest.raises(RuntimeError, match="exists already"):
        with mesh.fake_world(8):
            pass


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_specs_shapes_equal_reference(rdryrun, arch):
    rcfg, cfg = rconfigs.get(arch), configs.get(arch)

    def same(got, want):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)

    for k, v in rspecs.batch_specs(rcfg, 16, 1024).items():
        same(specs.batch_specs(cfg, 16, 1024)[k], v)
    ref = _ref_flat(rspecs.params_shapes(rcfg))
    for name, t in model_lib.flatten(specs.params_shapes(cfg)).items():
        r, stack = _ref_name(name)
        assert tuple(t.shape) == tuple(ref[r].shape)[stack:], name
        assert str(t.dtype).split(".")[-1] == str(ref[r].dtype)
    for shape in configs.SHAPES:
        cell = rconfigs.SHAPE_BY_NAME[shape.name]
        assert dryrun.model_flops(cfg, shape) == \
            rdryrun.model_flops(rcfg, cell)
    if cfg.supports_decode:
        cell = ShapeCell("d", 1024, 4, "decode")
        rcache, rtok, _ = rspecs.decode_specs(rcfg, cell)
        cache, tok, index = specs.decode_specs(cfg, cell)
        same(tok, rtok)
        assert index == 1023
        want = _ref_flat(rcache)
        for layer in cache:
            for k, v in layer.items():
                assert tuple(v.shape) == tuple(want[k].shape)[1:]
                assert str(v.dtype).split(".")[-1] == str(want[k].dtype)


@pytest.fixture(scope="module")
def qcd_records(world):
    group = torch.distributed.new_group(list(range(256)))
    recs = {}
    for lat_name in REF_QCD_BYTES:
        lat = configs.get_qcd(lat_name)
        for variant, kw in dryrun.QCD_VARIANTS.items():
            skip = dryrun.qcd_skip(lat, 16, 16, kw.get("overlap", "fused"))
            recs[lat_name, variant] = (
                {"status": "skip", "reason": skip} if skip else
                dryrun.run_qcd_cell(f"{lat_name}__dhat-{variant}__single",
                                    lat, group, 16, 16, **kw))
    return recs


def test_qcd_cells_ok_or_skip(rdryrun, qcd_records):
    for (lat_name, variant), rec in qcd_records.items():
        if variant == "split" and lat_name != "wilson-64x32x32x16":
            assert rec == {"status": "skip",
                           "reason": "split overlap needs local T,Z >= 2"}
        else:
            assert rec["status"] == "ok", (lat_name, variant)
            assert rec["n_devices"] == 256
            assert rec["model_flops_global"] == rdryrun.qcd_model_flops(
                rconfigs.get_qcd(lat_name))


@pytest.mark.parametrize("lat_name", list(REF_QCD_BYTES))
def test_qcd_collective_bytes(qcd_records, lat_name):
    T, Z, Y, X = configs.get_qcd(lat_name).shape
    Tl, Zl, Xh = T // 16, Z // 16, X // 2
    model = jhalo.halo_traffic_model(Tl, Zl, Y, Xh)
    for variant, want in REF_QCD_BYTES[lat_name].items():
        coll = qcd_records[lat_name, variant]["collectives"]
        assert coll["total_bytes"] == want, variant
        expect = model["bytes_dhat_exchange"] if variant != "opt" else \
            2 * model["bytes_spinor_exchange"]
        assert want == expect
        # two hops, each four faces of the source (and four of the gauge
        # where it is not hoisted), one message each
        assert coll["n_ops"] == (8 if variant == "opt" else 16)
    # opt-bf16: the port exchanges bf16 faces (2 bytes); the reference's
    # planar stencil computes in f32 before its exchange (4 bytes)
    assert qcd_records[lat_name, "opt-bf16"]["collectives"][
        "total_bytes"] == REF_QCD_BYTES[lat_name]["opt"] // 2


def test_qcd_split_bytes_are_faces_without_corners(qcd_records):
    """``split`` exchanges through ``start_exchange_tz``, whose z faces
    carry no t-corner rows: (2 Zl + 2 Tl) planes a face set, where the
    reference's ``split`` moves ``fused``'s (2 Zl + 2 (Tl + 2))."""
    T, Z, Y, X = configs.get_qcd("wilson-64x32x32x16").shape
    Tl, Zl, Xh = T // 16, Z // 16, X // 2
    per_site = (24 + 4 * 18) * 4          # spinor + gauge reals, f32
    want = 2 * per_site * (2 * Zl + 2 * Tl) * Y * Xh
    rec = qcd_records["wilson-64x32x32x16", "split"]
    assert rec["collectives"]["total_bytes"] == want == 6291456


NARROW = dict(n_layers=2, d_model=512, n_heads=16, n_kv_heads=16,
              head_dim=32, d_ff=1024, vocab_size=1024)
SMALL_CELL = ShapeCell("train_small", 128, 64, "train")


@pytest.fixture(scope="module")
def lm_record(world):
    cfg = configs.get("deepseek-7b").scaled(**NARROW)
    return dryrun.run_lm_cell("deepseek-7b__train_small__single", cfg,
                              SMALL_CELL, world["single"])


def test_lm_train_cell(lm_record):
    rec = lm_record
    assert rec["status"] == "ok" and rec["accum"] == 1
    for key in ("trace_s", "flops_per_device", "bytes_accessed_per_device",
                "arg_bytes_per_device", "out_bytes_per_device",
                "temp_bytes_per_device", "peak_bytes_per_device",
                "fit_bytes_per_device", "collectives", "model_flops_global",
                "exact"):
        assert key in rec, key
    assert rec["peak_bytes_per_device"] >= rec["arg_bytes_per_device"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert coll["n_ops"] == sum(coll["ops_by_kind"].values())
    # FSDP: weights gathered, gradients reduce-scattered
    assert {"all-gather", "reduce-scatter"} <= set(coll["bytes_by_kind"])
    # the independent sum, from the reference's specs: f32 parameters and
    # both moments, the batch's local rows, the 4-byte step count
    rcfg = rconfigs.get("deepseek-7b").scaled(**NARROW)
    rpol = _ref_policy("single")
    shapes = _ref_flat(rspecs.params_shapes(rcfg))
    sizes = {"data": 16, "model": 16}
    total = 0
    for name, spec in _ref_flat(rpol.param_specs(
            rspecs.params_shapes(rcfg))).items():
        n = int(np.prod(shapes[name].shape))
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[a]
        total += 3 * 4 * n
    rows = SMALL_CELL.global_batch // 16
    total += rows * SMALL_CELL.seq_len * (4 + 4) + 4
    assert rec["arg_bytes_per_device"] == total
    ratio = roofline.analyze(dict(rec, arch="deepseek-7b", mesh="single"))[
        "useful_flops_ratio"]
    assert 0.6 <= ratio <= 0.85, ratio


def test_roofline_terms_h100():
    rec = {"cell": "a__b__single", "status": "ok", "n_devices": 256,
           "arch": "a", "shape": "b", "mesh": "single",
           "model_flops_global": 256 * 7.5e12,
           "fit_bytes_per_device": 81e9,
           "exact": {"flops": 1e13, "bytes": 6.7e11, "coll": 2e9}}
    a = roofline.analyze(rec)
    assert a["t_compute_s"] == pytest.approx(1e13 / 989e12)
    assert a["t_memory_s"] == pytest.approx(0.2)
    assert a["t_collective_s"] == pytest.approx(0.04)
    assert a["dominant"] == "memory"
    assert a["roofline_fraction"] == pytest.approx((1e13 / 989e12) / 0.2)
    assert a["useful_flops_ratio"] == pytest.approx(0.75)
    assert a["step_time_bound_s"] == pytest.approx(0.2)
    assert a["gpu_seconds"] == pytest.approx(0.2 * 256)
    assert not a["fits_80gb"]
    assert roofline.analyze({"status": "skip"}) == {}
    assert "H100" in roofline.DEVICE and "700 W" in roofline.DEVICE

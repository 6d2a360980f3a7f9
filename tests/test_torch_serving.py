"""The port's serving daemon (``repro_torch.serving``,
``repro_torch.launch.serve``) on the CPU, held to the reference's
``repro.serving`` where the two can be compared: the batching and
admission policies, the error taxonomy, the npy/base64 codec and the
wire spec over grids of inputs; the queue with a fake clock in both
packages; the coalesced answer of three requests against the
reference's ``SolveSession.solve_block`` on the same padded block (the
only reference solve here); and the reference's serving assertions
carried over (ragged split-back, one build per bucket, typed
rejections, a NaN request contained, a recycle stream served in waves,
HTTP end to end, the CLI selftest).

Inputs are the reference suite's own: a 4x4x4x8 weak-field gauge
(``repro.core.su3.weak_gauge``, eps 0.2, seed 7, packed by
``repro.core.evenodd``) at kappa 0.1245 and sources drawn by its
``jax.random`` recipe, made once as numpy arrays and passed to both
packages.

Tolerances: the coalesced answer within 1e-4 absolute of the
reference's block solve (the batched parity tolerance of
``tests/test_torch_multirhs.py``: both packages iterate in f32 with
reductions summed in a different order) and within 1e-5 of the port's
solo solve (the reference's own serving tolerance); batchmates of a
poisoned request and served recycle iterations exactly equal.
"""
import dataclasses
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro import api as japi
from repro.core import evenodd as jeo, su3 as jsu3
from repro_torch import api, serving
from repro_torch.core import evenodd
from repro_torch.kernels import build
from repro_torch.launch import serve as launch_serve
from repro_torch.resilience import nan_spinor_column
from repro_torch.serving import (AdmissionPolicy, BadRequestError,
                                 BatchingPolicy, DrainingError,
                                 HttpServerThread, PropagatorDaemon,
                                 RequestTimeoutError, SessionPool,
                                 ShedError, UnknownMatrixError,
                                 decode_array, encode_array,
                                 spec_from_json)
from torch_threads import one_torch_thread  # noqa: F401

KAPPA = 0.1245
SHAPE = (4, 4, 4, 8)
BATCH_ATOL = 1e-4   # batched parity, tests/test_torch_multirhs.py
SOLO_ATOL = 1e-5    # coalesced against solo, tests/test_serving.py


@pytest.fixture(scope="module")
def gauge():
    """The reference suite's weak gauge (seed 7, eps 0.2), even/odd
    halves as numpy."""
    # One compile of each reference function (eagerly, op by op, they
    # take several seconds more).
    U = jax.jit(jsu3.weak_gauge, static_argnums=1)(jax.random.PRNGKey(7),
                                                   SHAPE)
    return tuple(np.array(a) for a in jax.jit(jeo.pack_gauge)(U))


@jax.jit
def _draw(k):
    shape = (*SHAPE, 4, 3)
    return (jax.random.normal(k, shape)
            + 1j * jax.random.normal(jax.random.fold_in(k, 1), shape)
            ).astype(jnp.complex64)


def _source(seed, nrhs=None):
    """The reference suite's source recipe (``jax.random`` draws, one
    compile), as numpy halves packed by the port's ``evenodd.pack`` (the
    reference's even/odd index map, held to it in
    tests/test_torch_evenodd.py).  Column ``j`` of a block is drawn from
    the key ``fold_in(PRNGKey(seed), 100 + j)``."""
    k = jax.random.PRNGKey(seed)
    keys = [k] if nrhs is None else [jax.random.fold_in(k, 100 + j)
                                     for j in range(nrhs)]
    cols = [evenodd.pack(torch.from_numpy(np.array(_draw(kj))))
            for kj in keys]
    e, o = (torch.stack(h) for h in zip(*cols))
    if nrhs is None:
        e, o = e[0], o[0]
    return e.numpy(), o.numpy()


def _tsource(seed, nrhs=None):
    return tuple(torch.from_numpy(a) for a in _source(seed, nrhs))


def _matrix(gauge, backend="torch_ref", **bind):
    Ue, Uo = (torch.from_numpy(a) for a in gauge)
    return api.WilsonMatrix.bind(Ue, Uo, KAPPA, backend=backend, **bind)


def _daemon(matrix, *, max_block=4, linger_s=0.05, buckets=(1, 2, 4),
            name="cfg", **kw):
    d = PropagatorDaemon(
        batching=BatchingPolicy(max_block=max_block, linger_s=linger_s,
                                buckets=buckets), **kw)
    d.register(name, matrix)
    return d


def _serve(daemon, sources, spec=None, name="cfg"):
    daemon.start()
    try:
        futs = [daemon.submit(name, e, o, spec) for e, o in sources]
        return [f.result(timeout=300) for f in futs]
    finally:
        daemon.drain()


# --- policy and taxonomy, against the reference ------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the type is compared
        return ("raise", type(exc).__name__)


BATCHING_GRID = [dict(), dict(max_block=1, buckets=(1,)),
                 dict(max_block=4, buckets=(1, 2, 4)),
                 dict(max_block=3, buckets=(2, 4)),
                 dict(max_block=8, buckets=(1, 2, 4)),
                 dict(buckets=(2, 1)), dict(buckets=(1, 1, 2)),
                 dict(buckets=()), dict(buckets=(0, 1)),
                 dict(max_block=0), dict(linger_s=-1.0),
                 dict(linger_s=0.0, max_block=2, buckets=(1, 2))]


@pytest.mark.parametrize("kw", BATCHING_GRID)
def test_batching_policy_matches_reference(kw):
    """The same buckets (over nrhs 0..9) and the same exception types."""
    mine = _outcome(lambda: BatchingPolicy(**kw))
    ref = _outcome(lambda: jserving.BatchingPolicy(**kw))
    assert (mine[0], mine[1] if mine[0] == "raise" else None) == \
        (ref[0], ref[1] if ref[0] == "raise" else None)
    if mine[0] == "ok":
        assert dataclasses.asdict(mine[1]) == dataclasses.asdict(ref[1])
        for n in range(10):
            assert _outcome(lambda: mine[1].bucket(n)) == \
                _outcome(lambda: ref[1].bucket(n)), n


@pytest.mark.parametrize("kw", [
    dict(), dict(max_queue_depth=1), dict(max_queue_depth=0),
    dict(default_timeout_s=None), dict(default_timeout_s=0.0),
    dict(default_timeout_s=-1.0), dict(default_timeout_s=2.5)])
def test_admission_policy_matches_reference(kw):
    mine = _outcome(lambda: AdmissionPolicy(**kw))
    ref = _outcome(lambda: jserving.AdmissionPolicy(**kw))
    if ref[0] == "ok":
        assert mine[0] == "ok"
        assert dataclasses.asdict(mine[1]) == dataclasses.asdict(ref[1])
    else:
        assert mine == ref


def test_bucket_quantization():
    p = BatchingPolicy(max_block=8, buckets=(1, 2, 4, 8))
    assert [p.bucket(n) for n in (1, 2, 3, 4, 5, 8)] == \
        [1, 2, 4, 4, 8, 8]
    with pytest.raises(ValueError):
        p.bucket(9)


@pytest.mark.parametrize("name", [
    "ServingError", "ShedError", "RequestTimeoutError", "DrainingError",
    "UnknownMatrixError", "BadRequestError"])
def test_error_taxonomy_matches_reference(name):
    mine, ref = getattr(serving, name), getattr(jserving, name)
    assert mine.__name__ == ref.__name__
    assert [b.__name__ for b in mine.__mro__] == \
        [b.__name__ for b in ref.__mro__]
    assert (mine.code, mine.http_status) == (ref.code, ref.http_status)
    if name != "ServingError":
        assert issubclass(mine, serving.ServingError)
        assert mine.code != "error"


def test_all_matches_reference():
    assert serving.__all__ == jserving.__all__
    for name in serving.__all__:
        assert hasattr(serving, name)


# --- codec and wire spec, against the reference ------------------------

CODEC_ARRAYS = [
    (np.arange(12, dtype=np.float32).reshape(3, 4)
     + 1j * np.ones((3, 4), np.float32)).astype(np.complex64),
    np.linspace(-1, 1, 10, dtype=np.float32).reshape(2, 5),
    np.zeros((1, 2, 2, 2, 1, 4, 3), np.complex64),
    np.asarray([[1.0, 2.0], [3.0, 4.0]]),
]


@pytest.mark.parametrize("i", range(len(CODEC_ARRAYS)))
def test_encode_array_matches_reference(i):
    """Byte-identical JSON, and each package decodes the other's."""
    a = CODEC_ARRAYS[i]
    mine, ref = encode_array(a), jserving.encode_array(a)
    assert json.dumps(mine) == json.dumps(ref)
    for b in (decode_array(ref), jserving.decode_array(mine)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)
    # a tensor encodes as its numpy array
    assert encode_array(torch.from_numpy(a)) == ref


def test_decode_array_lists_and_typed_errors():
    for obj in ([[1.0, 2.0]], [1, 2, 3], [[1.5]]):
        np.testing.assert_array_equal(decode_array(obj),
                                      jserving.decode_array(obj))
    for bad in ({"npy": "!!!"}, "nope", 3, None):
        with pytest.raises(BadRequestError):
            decode_array(bad)
        with pytest.raises(jserving.BadRequestError):
            jserving.decode_array(bad)


SPEC_PAYLOADS = [
    None, {}, {"method": "bicgstab", "tol": 1e-5}, {"method": "cg"},
    {"methd": "cg"}, {"method": "not-a-method"}, [1, 2], "cgnr",
    {"tol": -1.0}, {"max_iters": 0}, {"nrhs": 3}, {"nrhs": 0},
    {"inner_dtype": "bf16", "inner_tol": 1e-3}, {"inner_dtype": "f16"},
    {"deflate_rank": 8, "deflate_mode": "recycle"},
    {"deflate_rank": 8, "method": "bicgstab"},
    {"guard": False, "stagnation_window": 10}, {"max_restarts": -1},
    {"donate_rhs": True}, {"donate_rhs": False, "method": "cg"},
]


@pytest.mark.parametrize("i", range(len(SPEC_PAYLOADS)))
def test_spec_from_json_matches_reference(i):
    """The same accepted and refused payloads, and the same fields where
    accepted (the reference's ``donate_rhs`` is accepted and dropped)."""
    obj = SPEC_PAYLOADS[i]
    mine = _outcome(lambda: spec_from_json(obj))
    ref = _outcome(lambda: jserving.spec_from_json(obj))
    assert mine[0] == ref[0], (mine, ref)
    if ref[0] == "raise":
        assert mine[1] == ref[1] == "BadRequestError"
        return
    want = dataclasses.asdict(ref[1])
    want.pop("donate_rhs")
    assert dataclasses.asdict(mine[1]) == want


def test_spec_from_json_drops_donate_rhs():
    s = spec_from_json({"method": "cg", "donate_rhs": True})
    assert s == api.SolveSpec(method="cg")
    assert not hasattr(s, "donate_rhs")
    with pytest.raises(BadRequestError):   # the refused set is unchanged
        spec_from_json({"donate": True})


# --- queue (fake clock), both packages ---------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Src:
    """Array stand-in: the queue only reads ``shape[0]``."""

    def __init__(self, n):
        self.shape = (n,)


PACKAGES = {"port": serving, "reference": jserving}


def _queue(pkg, clock, **batching):
    m = PACKAGES[pkg]
    depth = batching.pop("max_queue_depth", 256)
    return m, m.RequestQueue(m.BatchingPolicy(**batching),
                             m.AdmissionPolicy(max_queue_depth=depth),
                             clock=clock)


def _req(m, key, n, clock, deadline=None):
    return m.SolveRequest(key, _Src(n), _Src(n), deadline=deadline,
                          submitted_at=clock(), future=Future())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_coalesces_to_max_block(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_block=4, linger_s=10.0, buckets=(1, 2, 4))
    for _ in range(5):
        q.submit(_req(m, "k", 1, clock))
    key, batch = q.wait_ready(stop_event=threading.Event())
    assert key == "k" and len(batch) == 4
    assert q.depth == 1  # fifth request waits for the next batch


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_linger_dispatches_ragged(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_block=4, linger_s=1.0, buckets=(1, 2, 4))
    q.submit(_req(m, "k", 1, clock))
    clock.t = 0.5
    q.submit(_req(m, "k", 2, clock))
    clock.t = 1.01  # oldest request's linger expired
    _, batch = q.wait_ready(stop_event=threading.Event())
    assert [r.nrhs for r in batch] == [1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_never_splits_a_request(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_block=4, linger_s=0.0, buckets=(1, 2, 4))
    q.submit(_req(m, "k", 3, clock))
    q.submit(_req(m, "k", 2, clock))  # 3+2 > 4: must not ride along
    _, batch = q.wait_ready(stop_event=threading.Event())
    assert [r.nrhs for r in batch] == [3]
    assert q.depth == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_sheds_at_depth(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_queue_depth=2)
    q.submit(_req(m, "k", 1, clock))
    q.submit(_req(m, "k", 1, clock))
    with pytest.raises(m.ShedError):
        q.submit(_req(m, "k", 1, clock))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_expires_with_partial_stats(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_block=4, linger_s=100.0,
                  buckets=(1, 2, 4))
    r = _req(m, "k", 1, clock, deadline=1.0)
    q.submit(r)
    clock.t = 2.0
    stop = threading.Event()
    stop.set()
    assert q.wait_ready(stop_event=stop) is None  # drained empty
    with pytest.raises(m.RequestTimeoutError) as ei:
        r.future.result(timeout=0)
    assert ei.value.stats["queued_s"] == pytest.approx(2.0)
    assert ei.value.stats["nrhs"] == 1 and ei.value.stats["queue_depth"] == 0
    assert q.depth == 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_keys_do_not_mix(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock, max_block=4, linger_s=0.0, buckets=(1, 2, 4))
    q.submit(_req(m, "a", 1, clock))
    q.submit(_req(m, "b", 1, clock))
    _, batch = q.wait_ready(stop_event=threading.Event())
    assert len(batch) == 1
    assert q.depth == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_queue_fail_all(pkg):
    clock = _Clock()
    m, q = _queue(pkg, clock)
    reqs = [_req(m, k, 1, clock) for k in ("a", "b", "a")]
    for r in reqs:
        q.submit(r)
    assert q.fail_all(m.DrainingError("closed")) == 3 and q.depth == 0
    for r in reqs:
        with pytest.raises(m.DrainingError):
            r.future.result(timeout=0)


# --- pool ---------------------------------------------------------------

def test_pool_lru_eviction(gauge):
    pool = SessionPool(capacity=2)
    m = _matrix(gauge)
    pool.register("a", m)
    pool.register("b", m)
    pool.entry("a")  # touch: "b" becomes LRU
    pool.register("c", m)
    assert pool.names() == ("a", "c")
    assert pool.stats()["evictions"] == ["b"]
    with pytest.raises(UnknownMatrixError):
        pool.entry("b")
    with pytest.raises(BadRequestError):
        pool.register("d", object())
    with pytest.raises(ValueError):
        SessionPool(capacity=0)


def test_pool_warmup_builds_one_pipeline_per_bucket(gauge):
    pool = SessionPool()
    pool.register("a", _matrix(gauge))
    # A short live solve is enough to show the build was reused.
    spec = api.SolveSpec(method="cgnr", tol=1e-6, max_iters=5)
    timings = pool.warmup("a", spec, buckets=(2, 1, 2))
    assert sorted(timings) == [1, 2]
    assert all(t > 0 for t in timings.values())
    st = pool.stats()["entries"]["a"]["session"]
    assert st["traces"] == 2 and st["solves"] == 2
    # zero sources converge at entry: no Krylov iteration
    assert all(row["iterations"] == [0] for row in st["keys"].values())
    # live traffic at a warmed bucket reuses the pipeline: no build
    e = pool.entry("a")
    e.session.solve_block(*_tsource(11, nrhs=2), spec)
    assert pool.stats()["entries"]["a"]["session"]["traces"] == 2


# --- the coalesced answer ----------------------------------------------

@pytest.fixture(scope="module")
def reference_block(gauge):
    """The reference's batched jnp cgnr on the padded bucket-4 block of
    sources 20, 21, 22 (the one reference solve of this file)."""
    srcs = [_source(20 + i) for i in range(3)]
    ee = np.stack([e for e, _ in srcs] + [np.zeros_like(srcs[0][0])])
    eo = np.stack([o for _, o in srcs] + [np.zeros_like(srcs[0][1])])
    Ue, Uo = (jnp.asarray(a) for a in gauge)
    session = japi.SolveSession(japi.WilsonMatrix.bind(Ue, Uo, KAPPA,
                                                       backend="jnp"))
    xe, xo, res, parts = session.solve_block(
        jnp.asarray(ee), jnp.asarray(eo),
        japi.SolveSpec(method="cgnr", tol=1e-6))
    return srcs, np.asarray(xe), np.asarray(xo), np.asarray(res.iterations)


@pytest.mark.parametrize("backend", ["torch_ref", "cuda_fused"])
def test_coalesced_matches_reference_and_solo(gauge, reference_block,
                                              backend):
    """Three requests served from one padded batch agree with the
    reference's block solve (BATCH_ATOL) and with the port's solo solves
    (SOLO_ATOL): coalescing is a scheduling decision, not a numerical
    one."""
    srcs, ref_e, ref_o, ref_iters = reference_block
    matrix = _matrix(gauge, backend)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    got = _serve(_daemon(matrix, linger_s=0.2),
                 [tuple(torch.from_numpy(a) for a in s) for s in srcs],
                 spec)
    assert len({r.stats["batch_id"] for r in got}) == 1  # one batch
    assert {r.stats["bucket"] for r in got} == {4}
    solo = api.SolveSession(_matrix(gauge, backend))
    for j, (r, (e, o)) in enumerate(zip(got, srcs)):
        assert r.converged and not r.diverged
        assert r.stats["backend"] == backend and not r.stats["degraded"]
        assert abs(r.stats["iterations"][0] - int(ref_iters[j])) <= 2
        np.testing.assert_allclose(r.xi_e[0].numpy(), ref_e[j], rtol=0,
                                   atol=BATCH_ATOL)
        np.testing.assert_allclose(r.xi_o[0].numpy(), ref_o[j], rtol=0,
                                   atol=BATCH_ATOL)
        xe, xo, _ = solo.solve(torch.from_numpy(e), torch.from_numpy(o),
                               spec)
        torch.testing.assert_close(r.xi_e[0], xe, rtol=0, atol=SOLO_ATOL)
        torch.testing.assert_close(r.xi_o[0], xo, rtol=0, atol=SOLO_ATOL)
    # the reference's padding column converged at entry, as the port's
    assert int(ref_iters[3]) == 0


@pytest.mark.parametrize("method", ["cgnr", "bicgstab", "blockcg"])
def test_padded_bucket_freezes_zero_columns(gauge, method):
    """3 columns in bucket 4: the zero column converges at entry and
    stays exactly zero (no NaN), and the daemon's answers equal the
    session's on the same padded block bit for bit."""
    srcs = [_tsource(40 + i) for i in range(3)]
    spec = api.SolveSpec(method=method, tol=1e-6)
    ee = torch.stack([e for e, _ in srcs] + [torch.zeros_like(srcs[0][0])])
    eo = torch.stack([o for _, o in srcs] + [torch.zeros_like(srcs[0][1])])
    session = api.SolveSession(_matrix(gauge))
    xe, xo, res, parts = session.solve_block(ee, eo, spec)
    assert torch.isfinite(torch.view_as_real(xe)).all()
    assert torch.isfinite(torch.view_as_real(xo)).all()
    assert int(res.iterations[3]) == 0
    assert bool(res.converged[3]) and not bool(res.diverged[3])
    assert not xe[3].any() and not xo[3].any()
    assert bool(res.converged.all())
    got = _serve(_daemon(_matrix(gauge), linger_s=0.2), srcs, spec)
    assert {r.stats["batch_columns"] for r in got} == {3}
    for j, r in enumerate(got):
        assert torch.equal(r.xi_e[0], xe[j]) and torch.equal(r.xi_o[0],
                                                              xo[j])
        assert r.stats["iterations"] == [int(res.iterations[j])]


def test_numpy_and_torch_sources_coalesce(gauge):
    """The key holds the tensor dtype after conversion: a numpy and a
    torch complex64 source share one batch."""
    e1, o1 = _source(31)
    e2, o2 = _tsource(32)
    got = _serve(_daemon(_matrix(gauge), linger_s=0.2),
                 [(e1, o1), (e2, o2)], api.SolveSpec(tol=1e-6))
    assert got[0].stats["batch_id"] == got[1].stats["batch_id"]
    assert got[0].stats["batch_columns"] == 2
    assert all(isinstance(r.xi_e, torch.Tensor) for r in got)


def test_ragged_split_back_per_request_stats(gauge):
    """A 1-column and a 2-column request share a batch; each gets its
    own iterations/residual/convergence lists of its own width."""
    d = _daemon(_matrix(gauge), linger_s=0.2)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    r1, r2 = _serve(d, [_tsource(31), _tsource(32, nrhs=2)], spec)
    assert r1.stats["batch_id"] == r2.stats["batch_id"]
    assert r1.stats["batch_columns"] == 3
    assert r1.stats["bucket"] == 4  # padded up: 1 build per bucket
    assert r1.stats["columns"] == [0, 1] and r2.stats["columns"] == [1, 3]
    assert len(r1.stats["iterations"]) == 1
    assert len(r2.stats["iterations"]) == 2
    assert r1.xi_e.shape[0] == 1 and r2.xi_e.shape[0] == 2
    assert r1.converged and r2.converged
    assert len(r1.stats["residual"]) == 1
    assert len(r2.stats["residual"]) == 2
    assert d.pool.stats()["entries"]["cfg"]["padded_columns"] == 1


def test_one_build_per_bucket(gauge):
    d = _daemon(_matrix(gauge), linger_s=0.15)
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    d.start()
    try:
        for wave in range(2):   # three singles -> bucket 4, twice
            futs = [d.submit("cfg", *_tsource(40 + 10 * wave + i), spec)
                    for i in range(3)]
            [f.result(timeout=300) for f in futs]
    finally:
        d.drain()
    sess = d.pool.stats()["entries"]["cfg"]["session"]
    assert sess["traces"] == 1
    assert len(sess["keys"]) == 1
    m = d.metrics()
    assert m["batches"] == 2 and m["completed"] == 6
    assert m["mean_batch_columns"] == 3.0


# --- rejection paths never poison the pool -----------------------------

def test_shed_is_typed_and_pool_survives(gauge):
    d = _daemon(_matrix(gauge), linger_s=0.1,
                admission=AdmissionPolicy(max_queue_depth=1))
    # not started: requests stay queued, so the second submit sheds
    f1 = d.submit("cfg", *_tsource(60))
    with pytest.raises(ShedError):
        d.submit("cfg", *_tsource(61))
    d.start()
    try:
        assert f1.result(timeout=300).converged
        # the shed left no residue: a later request is served normally
        assert d.submit("cfg", *_tsource(62)).result(
            timeout=300).converged
    finally:
        d.drain()
    assert not d.pool.stats()["entries"]["cfg"]["degraded"]
    assert d.metrics()["shed"] == 1


def test_timeout_cancels_with_partial_stats(gauge):
    d = _daemon(_matrix(gauge), linger_s=0.5)  # linger past the deadline
    d.start()
    try:
        fut = d.submit("cfg", *_tsource(63), timeout_s=0.05)
        with pytest.raises(RequestTimeoutError) as ei:
            fut.result(timeout=60)
        assert ei.value.stats["queued_s"] >= 0.05
        assert ei.value.stats["nrhs"] == 1
        # daemon still serves after the cancellation
        assert d.submit("cfg", *_tsource(64),
                        timeout_s=120).result(timeout=300).converged
    finally:
        d.drain()


def test_draining_rejects_new_work(gauge):
    d = _daemon(_matrix(gauge))
    d.start()
    d.drain()
    with pytest.raises(DrainingError):
        d.submit("cfg", *_tsource(65))


def test_close_fails_queued_requests(gauge):
    d = _daemon(_matrix(gauge), linger_s=60.0)
    fut = d.submit("cfg", *_tsource(65))
    d.close()
    with pytest.raises(DrainingError):
        fut.result(timeout=0)
    assert d.metrics()["failed"] == 1


def test_bad_shapes_and_unknown_matrix_are_typed(gauge):
    d = _daemon(_matrix(gauge))
    with pytest.raises(UnknownMatrixError):
        d.submit("nope", *_tsource(66))
    with pytest.raises(BadRequestError):
        d.submit("cfg", torch.zeros((3, 3)), torch.zeros((3, 3)))
    with pytest.raises(BadRequestError):   # not an array
        d.submit("cfg", [1.0], [1.0])
    wide = torch.zeros((5, *api.LatticeSpec(SHAPE).spinor_eo_shape()),
                       dtype=torch.complex64)
    with pytest.raises(BadRequestError):   # more columns than max_block
        d.submit("cfg", wide, wide)
    eta_e, eta_o = _tsource(68)
    with pytest.raises(BadRequestError):   # wrong lattice
        d.submit("cfg", eta_e[:, :2], eta_o[:, :2])
    with pytest.raises(BadRequestError):   # even/odd dtypes disagree
        d.submit("cfg", eta_e, eta_o.to(torch.complex128))
    with pytest.raises(BadRequestError):
        d.submit("cfg", eta_e, eta_o, spec="cgnr")
    assert d.queue.depth == 0


def test_failed_batch_fails_its_requests_only(gauge):
    """A solve that raises (fallback off) fails the requests of its
    batch; the daemon goes on serving the next batch."""
    from repro_torch.resilience import InjectedFault, break_ops
    matrix = _matrix(gauge)
    good_ops = matrix.ops
    matrix.ops = break_ops(good_ops)
    d = _daemon(matrix, linger_s=0.1)
    d.start()
    try:
        fut = d.submit("cfg", *_tsource(69))
        with pytest.raises(InjectedFault):
            fut.result(timeout=300)
        matrix.ops = good_ops
        assert d.submit("cfg", *_tsource(69)).result(timeout=300).converged
    finally:
        d.drain()
    m = d.metrics()
    assert m["failed"] == 1 and m["completed"] == 1


# --- chaos: a poisoned request contained within its batch --------------

def test_nan_request_contained_in_shared_batch(gauge):
    """One request's NaN source must not leak into batchmates: their
    answers stay bit-identical to a clean run, and only the poisoned
    request reports diverged."""
    spec = api.SolveSpec(method="cgnr", tol=1e-6)
    clean_sources = [_tsource(70 + i) for i in range(3)]
    matrix = _matrix(gauge)
    clean = _serve(_daemon(matrix, linger_s=0.2), clean_sources, spec)
    poisoned = list(clean_sources)
    pe, po = poisoned[1]
    poisoned[1] = (nan_spinor_column(pe[None], 0)[0], po)
    chaos = _serve(_daemon(matrix, linger_s=0.2), poisoned, spec)
    assert len({r.stats["batch_id"] for r in chaos}) == 1
    assert chaos[1].diverged and not chaos[1].converged
    assert chaos[1].stats["diverged"] == [True]
    for j in (0, 2):
        assert chaos[j].converged and not chaos[j].diverged
        assert torch.equal(chaos[j].xi_e, clean[j].xi_e)
        assert torch.equal(chaos[j].xi_o, clean[j].xi_o)
        assert chaos[j].stats["iterations"] == clean[j].stats["iterations"]


# --- a recycle stream served in waves ----------------------------------

@pytest.mark.parametrize("method", ["cg", "blockcg"])
def test_recycle_deflation_fills_from_served_stream(gauge, method):
    """Individually-submitted requests coalesce into batched solves;
    every converged column is harvested into the recycle span, and the
    iteration count drops across the served stream.  The served
    iterations equal those of the port's own session fed the same
    blocks, solved in this thread while the daemon solves each wave:
    serving is scheduling, not numerics."""
    spec = api.SolveSpec(method=method, tol=1e-6, deflate_rank=24,
                         deflate_mode="recycle")
    waves = [[_tsource(80 + 4 * wave + i) for i in range(4)]
             for wave in range(6)]
    d = _daemon(_matrix(gauge), linger_s=0.3)
    session = api.SolveSession(_matrix(gauge))
    iters = []
    d.start()
    try:
        for wave in waves:
            futs = [d.submit("cfg", e, o, spec) for e, o in wave]
            own = session.solve_block(torch.stack([e for e, _ in wave]),
                                      torch.stack([o for _, o in wave]),
                                      spec)[2]
            rs = [f.result(timeout=300) for f in futs]
            assert all(r.converged for r in rs)
            assert len({r.stats["batch_id"] for r in rs}) == 1
            served = [r.stats["iterations"][0] for r in rs]
            assert served == [int(k) for k in own.iterations]
            iters.append(max(served))
    finally:
        d.drain()
    entry = d.pool.stats()["entries"]["cfg"]
    row = next(iter(entry["session"]["keys"].values()))
    assert row["deflation"]["mode"] == "recycle"
    assert row["deflation"]["filled"] > 0
    assert row["deflation"]["harvested"] >= row["deflation"]["filled"]
    # batched solves fed the span: later waves solve strictly cheaper
    assert iters[-1] < iters[0], iters


# --- HTTP front end ----------------------------------------------------

def _post(base, payload, timeout=300):
    body = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(base + "/v1/solve", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _http_error(base, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, payload, timeout=30)
    return ei.value.code, json.loads(ei.value.read())


def test_http_end_to_end_with_typed_errors(gauge):
    d = _daemon(_matrix(gauge), linger_s=0.15)
    d.start()
    srv = HttpServerThread(d, port=0)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/v1/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        assert hz["ok"] and hz["matrices"] == ["cfg"] \
            and not hz["draining"]

        def one(i):
            eta_e, eta_o = _source(100 + i)
            return _post(base, {
                "matrix": "cfg", "eta_e": encode_array(eta_e),
                "eta_o": encode_array(eta_o),
                "spec": {"method": "cgnr", "tol": 1e-6,
                         "donate_rhs": True}})

        with ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(one, range(3)))
        assert len({o["stats"]["batch_id"] for o in outs}) == 1
        for o in outs:
            assert o["stats"]["converged"] == [True]
            xi = decode_array(o["xi_e"])
            assert xi.dtype == np.complex64
            assert xi.shape == (1,) + api.LatticeSpec(
                SHAPE).spinor_eo_shape()

        code, err = _http_error(base, {"matrix": "nope", "eta_e": [1.0],
                                       "eta_o": [1.0]})
        assert (code, err["error"]) == (404, "unknown_matrix")
        code, err = _http_error(base, b"not json")
        assert (code, err["error"]) == (400, "bad_request")
        code, err = _http_error(base, {"eta_e": [1.0]})
        assert (code, err["error"]) == (400, "bad_request")
        code, err = _http_error(base, {"matrix": "cfg", "eta_e": [1.0],
                                       "eta_o": [1.0]})
        assert (code, err["error"]) == (400, "bad_request")
        code, err = _http_error(base, {"matrix": "cfg", "eta_e": [1.0],
                                       "eta_o": [1.0],
                                       "spec": {"methd": "cg"}})
        assert (code, err["error"]) == (400, "bad_request")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/v1/nowhere", timeout=30)
        assert ei.value.code == 404

        with urllib.request.urlopen(base + "/v1/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["completed"] == 3
        assert m["mean_batch_columns"] == 3.0
        assert m["pool"]["entries"]["cfg"]["session"]["traces"] == 1
    finally:
        srv.stop()
        d.drain()


def test_metrics_shape_without_traffic(gauge):
    d = _daemon(_matrix(gauge))
    srv = HttpServerThread(d, port=0)
    host, port = srv.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/v1/metrics",
                                    timeout=30) as r:
            wire = json.loads(r.read())
    finally:
        srv.stop()
    m = d.metrics()
    assert m["mean_batch_columns"] is None
    assert m["queue_depth"] == 0
    assert m["batching"]["buckets"] == [1, 2, 4]
    assert "cfg" in m["pool"]["entries"]
    assert m["pool"]["entries"]["cfg"]["device"] == "cpu"
    assert wire == json.loads(json.dumps(m))  # the report is wire-clean


def test_metrics_while_the_dispatcher_adds_keys(gauge):
    """``/v1/metrics`` reads the session's stats from another thread
    while the dispatcher adds a key per spec (8 keys, a short switch
    interval): no iteration error, every key reported."""
    d = _daemon(_matrix(gauge), linger_s=0.0)
    stop = threading.Event()
    errors = []

    def poll():
        while not stop.is_set():
            try:
                d.metrics()
            except Exception as exc:  # noqa: BLE001 — collected
                errors.append(exc)

    t = threading.Thread(target=poll)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    d.start()
    t.start()
    try:
        futs = [d.submit("cfg", *_tsource(110),
                         api.SolveSpec(tol=10.0 ** -(k + 2), max_iters=1),
                         timeout_s=None)
                for k in range(1, 9)]
        [f.result(timeout=300) for f in futs]
    finally:
        stop.set()
        t.join(timeout=60)
        d.drain()
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert not errors, errors[:3]
    assert len(d.metrics()["pool"]["entries"]["cfg"]["session"]["keys"]) \
        == 8


# --- the CLI -------------------------------------------------------------

def test_cli_selftest_on_cpu(capsys):
    rc = launch_serve.main(["--lattice", "4x4x4x8", "--device", "cpu",
                            "--selftest", "6", "--port", "0",
                            "--linger-ms", "200"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "selftest PASS" in out
    assert "backend torch_ref" in out


def test_cli_refuses_donate_and_defaults_to_cuda():
    with pytest.raises(SystemExit):
        launch_serve.main(["--donate"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--backend", "pallas_fused"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch_serve.main(["--lattice", "4x4x4x8", "--selftest", "2"])


# --- the kernel build under two threads --------------------------------

def test_kernel_build_is_thread_safe(tmp_path, monkeypatch):
    """Threads calling ``build.load`` at once (a daemon's dispatcher and
    its front end; here 16, more than the cores, with a short switch
    interval) build each library once: the compiler (stubbed here) runs
    once per source, the library is loaded once and every thread gets
    it."""
    calls, loads = [], []

    class FakePopen:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)   # the window a second build would use
            with open(self.out, "w") as f:
                f.write("lib")
            return "ptxas info: stub", None

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_loaded", {})
    n = 16
    barrier = threading.Barrier(n)
    got = []

    def worker():
        barrier.wait(timeout=30)
        got.append(build.load("wilson_hop"))

    threads = [threading.Thread(target=worker) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == len(build.KERNEL_SOURCES)
    assert len(loads) == 1 and len(got) == n
    assert all(lib is got[0] for lib in got)
    assert not list(tmp_path.glob("*.tmp"))

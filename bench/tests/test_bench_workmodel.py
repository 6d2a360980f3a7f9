"""The frozen work model of ``dhat_roofline`` against figures worked out
by hand."""
import json

import pytest
from bench_testutil import ROOT

from bench import workmodel


def _even_sites(config, world=1):
    T, Z, Y, X = config["lattice"]
    return T * Z * Y * X // (2 * world)


@pytest.mark.parametrize("nrhs, want", [
    # 524288 even sites: spinors 2 x 96 B a site a column, links
    # 2 parities x 4 directions x 8 reals x 4 B
    (1, 2 * 524288 * 96 + 2 * 4 * 524288 * 32),        # 234881024
    (12, 12 * 2 * 524288 * 96 + 2 * 4 * 524288 * 32),  # 1342177280
])
def test_bytes_at_64x32x32x16(nrhs, want):
    cfg = json.loads((ROOT / "bench/configs/wilson-64x32x32x16.json")
                     .read_text())
    assert _even_sites(cfg) == 524288
    assert workmodel.dhat_bytes(524288, nrhs) == want
    assert want == {1: 234881024, 12: 1342177280}[nrhs]


def test_bytes_at_production_per_rank():
    cfg = json.loads((ROOT / "bench/configs/wilson-production.json")
                     .read_text())
    ve = _even_sites(cfg, world=4)
    assert ve == 4194304
    # 3 columns: 3 x 2 x 4194304 x 96 B + 2 x 4 x 4194304 x 32 B
    assert workmodel.dhat_bytes(ve, 3) == 2415919104 + 1073741824


@pytest.mark.parametrize("nrhs", [1, 3, 12])
def test_bytes_bind_the_bound(nrhs):
    ve = 524288
    bound = workmodel.dhat_bound_s(ve, nrhs)
    assert bound == workmodel.dhat_bytes(ve, nrhs) / 3.35e12
    assert workmodel.dhat_flops(ve, nrhs) / 67e12 < bound
    # one source: 234881024 B / 3.35 TB/s = 70.1 us
    if nrhs == 1:
        assert bound == pytest.approx(70.1138e-6, rel=1e-4)

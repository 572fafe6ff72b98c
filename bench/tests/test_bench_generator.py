"""The seeded inputs: the same seed gives the same inputs, and every seed
the same work."""
import numpy as np
import pytest
import torch
from conftest import small_config, small_traffic

from benchlib import model
from reference import slab as ref

CPU = torch.device("cpu")
SEEDS = (0, 2 ** 31 + 11)


@pytest.mark.parametrize("name", ["slab-sift128-f32",
                                  "slab-pooled4096-bf16"])
def test_the_same_seed_draws_the_same_inputs(name):
    cfg, trf = small_config(name), small_traffic("bulk")
    a, pa = model.draw(SEEDS[1], cfg, trf, CPU)
    b, pb = model.draw(SEEDS[1], cfg, trf, CPU)
    c, pc = model.draw(SEEDS[0], cfg, trf, CPU)
    assert torch.equal(a.t, b.t) and torch.equal(pa, pb)
    assert torch.equal(a.gamma, b.gamma)
    assert (a.rho1, a.rho2) == (b.rho1, b.rho2)
    assert not torch.equal(a.t, c.t) and not torch.equal(pa, pc)
    assert a.t.dtype == model.DTYPES[cfg["precision"]]
    assert pa.shape == (model.pool_rows(cfg, trf), cfg["d"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_slab_lies_in_the_spec_s_box_with_both_signs(seed):
    cfg, trf = small_config("slab-sift128-f32"), small_traffic("bulk")
    s, pool = model.draw(seed, cfg, trf, CPU)
    m = cfg["train_rows"]
    spec = cfg["spec"]
    g = s.gamma.double()
    assert g.max() <= 1 / (spec["nu1"] * m)
    assert g.min() >= -spec["eps"] / (spec["nu2"] * m)
    assert g.abs().min() > 1e-7             # packing keeps every row
    assert float(g.sum()) == pytest.approx(1 - spec["eps"], rel=1e-5)
    assert s.rho1 < s.rho2
    d = ref.decision(pool, s.t, s.gamma, s.rho1, s.rho2, s.kgamma)
    assert (d > 0).any() and (d < 0).any()


def test_every_seed_sends_the_same_sizes_and_gaps_in_another_order():
    from benchlib import cells
    open_loop = cells.module("drivers", "open")
    trf = cells.traffic("online")
    runs = [open_loop.schedule(trf, 10.0, s, 262144) for s in SEEDS]
    (s0, d0, o0), (s1, d1, o1) = runs
    assert sorted(s0) == sorted(s1) and not np.array_equal(s0, s1)
    qs = [0.1, 0.5, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(np.diff(d0), qs),
                               np.quantile(np.diff(d1), qs), rtol=0.01)
    assert d0[-1] == pytest.approx(d1[-1], rel=0.02)
    assert len(set(np.unique(s0, return_counts=True)[1])) == 1
    rate = s0.sum() / d0[-1]
    assert rate == pytest.approx(trf["rate_rows_per_s"], rel=0.05)
    assert (o0 + s0 <= 262144).all() and (o0 >= 0).all()
    again = open_loop.schedule(trf, 10.0, SEEDS[0], 262144)
    assert all(np.array_equal(x, y) for x, y in zip(runs[0], again))


def test_the_pool_exceeds_the_l2_cache_at_the_cells_sizes():
    from benchlib import cells
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cfg = cells.config(bench, w["config"])
        trf = cells.traffic(w["traffic"])
        rows = model.pool_rows(cfg, trf)
        assert rows * cfg["d"] * 4 >= 100 * 2 ** 20
        assert rows >= 8 * max(trf["rows"])

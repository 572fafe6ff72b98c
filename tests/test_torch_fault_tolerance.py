"""The port's fault-tolerant loop and heartbeat table held against the JAX
package's.

* ``HeartbeatTable``: the same beats give the same stragglers and dead
  nodes.
* Both packages' ``FaultTolerantLoop`` over one solver-chunk step (a few
  outer iterations of ``solve_blocked`` from the state's gamma, m = 64),
  with failures injected at the same steps: equal restarts and the same
  steps run, gamma within ``truth_tolerance`` + the solver floor (the
  two solvers part on near-ties, ROADMAP C.6).
* The port alone: the restarted run is bitwise its uninterrupted run;
  too many failures raise with ``restarts == max_restarts + 1``; the data
  cursor resumes from the checkpoint; a restart before any checkpoint
  starts from the true initial state although a step updated the state
  in place.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.kernels.precision import truth_tolerance
from repro.runtime import fault_tolerance as jft
from repro_torch.core import SlabSpec, rbf, solve_blocked
from repro_torch.data import make_toy
from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                 HeartbeatTable)

SOLVER_ATOL_FLOOR = 5e-3
M, CHUNK = 64, 25         # rows; outer iterations a step
X = make_toy(0, M)[0]
T_SPEC = SlabSpec(nu1=0.5, nu2=0.1, eps=0.5, kernel=rbf(gamma=0.5))
J_SPEC = jc.SlabSpec(nu1=0.5, nu2=0.1, eps=0.5, kernel=jc.rbf(gamma=0.5))


class Cursor:
    """A data pipeline whose batches are its step count."""

    def __init__(self):
        self.step = 0

    def next_batch(self):
        self.step += 1
        return self.step

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = d["step"]


def _torch_step(state, batch):
    res = solve_blocked(torch.as_tensor(X), T_SPEC, P=4, tol=1e-3,
                        gamma0=state["gamma"], max_outer=CHUNK)
    return ({"gamma": res.model.gamma, "rho1": res.model.rho1,
             "rho2": res.model.rho2, "iters": state["iters"] + res.iters},
            {"gap": res.gap, "batch": batch})


def _jax_step(state, batch):
    res = jc.solve_blocked(jnp.asarray(X), J_SPEC, P=4, tol=1e-3,
                           gamma0=state["gamma"], max_outer=CHUNK)
    return ({"gamma": res.model.gamma, "rho1": res.model.rho1,
             "rho2": res.model.rho2, "iters": state["iters"] + res.iters},
            {"gap": res.gap, "batch": batch})


def _injector(fails):
    fails = set(fails)

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise RuntimeError("injected")
    return inject


def _torch_loop(path, fails=(), **kw):
    g0 = torch.full((M,), T_SPEC.total() / M)
    init = {"gamma": g0, "rho1": torch.tensor(0.0), "rho2": torch.tensor(0.0),
            "iters": torch.tensor(0, dtype=torch.int32)}
    return FaultTolerantLoop(_torch_step, init, Cursor(), str(path),
                             save_every=2, failure_injector=_injector(fails),
                             **kw)


def _jax_loop(path, fails=()):
    g0 = jnp.full((M,), J_SPEC.total() / M)
    init = {"gamma": g0, "rho1": jnp.float32(0), "rho2": jnp.float32(0),
            "iters": jnp.int32(0)}
    return jft.FaultTolerantLoop(_jax_step, init, Cursor(), str(path),
                                 save_every=2,
                                 failure_injector=_injector(fails))


def test_heartbeats_match_the_reference():
    tables = [HeartbeatTable(n_nodes=5, timeout_s=5.0, straggler_factor=2.0),
              jft.HeartbeatTable(n_nodes=5, timeout_s=5.0,
                                 straggler_factor=2.0)]
    rng = np.random.default_rng(3)
    slow = {2: 3.5, 4: 2.5}
    for node in range(5):
        for i in range(5):
            st = slow.get(node, 1.0) + float(rng.uniform(0, 0.2))
            for hb in tables:
                hb.beat(node, step_time=st, now=1000.0 + i)
    for hb in tables:
        hb.last_beat[3] = 900.0
    t, j = tables
    assert t.stragglers() == j.stragglers() == [2, 4]
    for now in (1004.0, 1008.0, 1009.5, 1020.0):
        assert t.dead_nodes(now=now) == j.dead_nodes(now=now)
    assert t.dead_nodes(now=1008.0) == [3]
    assert t.dead_nodes(now=1009.5) == [0, 1, 2, 3, 4]
    assert HeartbeatTable(n_nodes=2).stragglers() == []


def test_loops_match_the_reference(tmp_path):
    tl = _torch_loop(tmp_path / "torch", fails=(3, 6))
    jl = _jax_loop(tmp_path / "jax", fails=(3, 6))
    ts, js = tl.run(8), jl.run(8)
    assert tl.restarts == jl.restarts == 2
    assert sorted({m["step"] for m in tl.metrics_log}) == \
        sorted({m["step"] for m in jl.metrics_log}) == list(range(8))
    assert [m["step"] for m in tl.metrics_log] == \
        [m["step"] for m in jl.metrics_log]
    assert tl.pipeline.step == jl.pipeline.step == 8
    assert max(tl.metrics_log[-1]["gap"], jl.metrics_log[-1]["gap"]) <= 1e-3
    g_t, g_j = ts["gamma"].numpy(), np.asarray(js["gamma"])
    tol = truth_tolerance("f32", g_j)
    np.testing.assert_allclose(g_t, g_j, rtol=tol["rtol"],
                               atol=tol["atol"] + SOLVER_ATOL_FLOOR)
    assert abs(float(g_t.sum()) - T_SPEC.total()) < 1e-5
    assert int(ts["iters"]) > CHUNK


def test_restarted_run_is_bitwise_the_uninterrupted_run(tmp_path):
    clean = _torch_loop(tmp_path / "clean")
    failed = _torch_loop(tmp_path / "failed", fails=(1, 3, 6))
    a, b = clean.run(8), failed.run(8)
    assert clean.restarts == 0 and failed.restarts == 3
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
    # replayed steps log the same metrics
    by_step = {m["step"]: m["gap"] for m in clean.metrics_log}
    assert all(by_step[m["step"]] == m["gap"] for m in failed.metrics_log)
    # keep=3 of the saves at steps 1, 3, 5, 7
    assert sorted(p.name for p in (tmp_path / "failed").iterdir()) == [
        "step_000000003", "step_000000005", "step_000000007"]


def test_too_many_failures_raises(tmp_path):
    def always(step):
        raise RuntimeError("always failing")

    loop = _torch_loop(tmp_path, max_restarts=3)
    loop.failure_injector = always
    with pytest.raises(RuntimeError, match="always failing"):
        loop.run(5)
    assert loop.restarts == 4


@pytest.mark.parametrize("fails", [(), (3,)])
def test_data_cursor_resumes(tmp_path, fails):
    loop = _torch_loop(tmp_path, fails=fails)
    loop.run(4)
    # the cursor advanced once per executed step (replays restored it)
    assert loop.pipeline.step == 4
    assert [m["batch"] for m in loop.metrics_log] == (
        [1, 2, 3, 4] if not fails else [1, 2, 3, 3, 4])


def test_restart_before_any_checkpoint_restores_the_initial_state(tmp_path):
    """The step updates the state in place; a failure before the first
    save restarts from the initial state as it was when the loop was
    made, not from the mutated one (nor from the caller's tensors,
    updated in place after that)."""
    def bump(state, batch):
        state["x"].add_(1.0)
        return state, {"x": state["x"].sum()}

    for fails, restarts in (((), 0), ((2,), 1), ((1, 2), 2)):
        init = {"x": torch.zeros(3, dtype=torch.float64)}
        loop = FaultTolerantLoop(bump, init, Cursor(), str(tmp_path / str(
            restarts)), save_every=100, failure_injector=_injector(fails))
        init["x"].add_(10.0)
        out = loop.run(4)
        assert loop.restarts == restarts
        assert out["x"].dtype == torch.float64
        assert out["x"].tolist() == [4.0, 4.0, 4.0]
        assert init["x"].tolist() == [10.0, 10.0, 10.0]

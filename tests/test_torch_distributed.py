"""The port's row-sharded solver held against the JAX package's.

``solve_blocked_distributed``, its ``CollectiveLedger``, the fused
``solver_stats_prev`` and the solver meshes. The JAX side runs through
``conftest.run_forced_devices`` (8 forced host devices, one subprocess
for the whole matrix); the port side runs 4 gloo ranks spawned once for
the whole matrix (``repro_torch.launch.spawn_ranks``, a ``file://``
rendezvous under the test's temporary directory); the two run at once.
Both read the same numpy rows, made from a seed.

Tolerances: objective and offsets within ``max(truth_tolerance,
SOLVER_ATOL_FLOOR)`` (tests/test_engine_parity.py's floor: two converged
solves stop anywhere inside the tol-sized gap), iterations within 10%
(the f32 sums run in other orders, so a near-tie can part the
trajectories: ROADMAP C.6); after 10 iterations gamma within 1e-6 of the
reference's, which shows the same working sets; the ledger's summary
equal to the reference's; the fused statistics within 1e-6.

Time limits: the ranks' join and process-group timeout is RANKS_TIMEOUT_S,
the JAX subprocess's JAX_TIMEOUT_S, so a hang fails its tests instead of
running out the suite's clock.
"""
import json
import math
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_forced_devices
import repro.core.engine.stats as jstats
from repro.kernels.precision import truth_tolerance
import repro_torch
import repro_torch.core as tc
import repro_torch.core.engine.stats as tstats
from repro_torch.core.engine import CollectiveLedger
from repro_torch.data import make_toy
from repro_torch.kernels.precision import round_to_tile
from repro_torch.launch import make_solver_mesh, make_test_mesh, spawn_ranks
import torch_dist_ranks

SOLVER_ATOL_FLOOR = 5e-3
P, TOL = 8, 1e-3
RANKS, RANKS_TIMEOUT_S, JAX_TIMEOUT_S = 4, 240, 600
M_MAX = 2048
# A (4,) mesh at m = 256 and a ("pod", "data") = (2, 2) mesh at m = 240.
MESHES = {
    "data4": dict(shape=(4,), axes=("data",), data_axes=("data",), m=256),
    "pod2x2": dict(shape=(2, 2), axes=("pod", "data"),
                   data_axes=("pod", "data"), m=240),
}
# Rows that do not split evenly over the 4 ranks (two pad rows, 63 rows a
# rank): the reference's sharded solve raises there under jax 0.9.0
# (ROADMAP C.10), so the port is held against its single-device solve.
PAD_M = 250
KERNELS, PRECISIONS = ("rbf", "linear"), ("f32", "bf16")
CELLS = [(mesh, k, p) for mesh in MESHES for k in KERNELS
         for p in PRECISIONS]
FIRST_ITERS = 10

JAX_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core import SlabSpec, linear, rbf, solve_blocked
from repro.core.distributed_smo import solve_blocked_distributed
from repro.core.engine import CollectiveLedger
X = np.load(XPATH)
job = json.loads(JOB)
out = {}
for name, mj in job["meshes"].items():
    mesh = jax.make_mesh(tuple(mj["shape"]), tuple(mj["axes"]),
                         devices=jax.devices()[:4])
    for key, (kname, precision, m, max_outer) in mj["cells"].items():
        if key.startswith("pad-"):          # the port's only (C.10)
            continue
        spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5,
                        kernel=rbf(0.5) if kname == "rbf" else linear())
        led = CollectiveLedger()
        r = solve_blocked_distributed(
            jnp.asarray(X[:m]), spec, mesh,
            data_axes=tuple(mj["data_axes"]), P_pairs=job["P"],
            tol=job["tol"], max_outer=max_outer, precision=precision,
            ledger=led)
        out[name + "/" + key] = dict(
            gamma=np.asarray(r.model.gamma).tolist(),
            rho=[float(r.model.rho1), float(r.model.rho2)],
            iters=int(r.iters), converged=bool(r.converged),
            ledger=led.summary())
for key, (kname, precision, m) in job["single"].items():
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5,
                    kernel=rbf(0.5) if kname == "rbf" else linear())
    r = solve_blocked(jnp.asarray(X[:m]), spec, P=job["P"], tol=job["tol"],
                      precision=precision)
    out[key] = dict(gamma=np.asarray(r.model.gamma).tolist(),
                    rho=[float(r.model.rho1), float(r.model.rho2)],
                    iters=int(r.iters), converged=bool(r.converged))
print(json.dumps(out))
"""


def _job():
    meshes = {}
    for name, mj in MESHES.items():
        cells = {}
        for k in KERNELS:
            for p in PRECISIONS:
                cells[f"{k}-{p}"] = (k, p, mj["m"], 50_000)
                cells[f"{k}-{p}-first"] = (k, p, mj["m"], FIRST_ITERS)
        meshes[name] = dict(mj, cells=cells)
    # The ledger at a larger m: the per-iteration bill must not move.
    meshes["data4"]["cells"]["ledger-2048"] = ("rbf", "f32", M_MAX, 50)
    single = {}
    for k in KERNELS:
        for p in PRECISIONS:
            meshes["data4"]["cells"][f"pad-{k}-{p}"] = (k, p, PAD_M, 50_000)
            single[f"single/pad-{k}-{p}"] = (k, p, PAD_M)
    return dict(meshes=meshes, single=single, P=P, tol=TOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    X = make_toy(1, M_MAX)[0]
    xpath = str(tmp / "X.npy")
    np.save(xpath, X)
    job = _job()
    code = JAX_CODE.replace("XPATH", repr(xpath)).replace(
        "JOB", repr(json.dumps(job)))
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_forced_devices, code, devices=8,
                               timeout=JAX_TIMEOUT_S)
        port = spawn_ranks(torch_dist_ranks.solve_cells, RANKS,
                           args=(dict(job, X=X),), timeout_s=RANKS_TIMEOUT_S,
                           dir=str(tmp))
        ref = jax_side.result()
    return dict(X=X, jax=ref, port=port)


def _objective(gamma, K):
    g = np.asarray(gamma, np.float64)
    return 0.5 * g @ K @ g


def _within(a, b, precision, what):
    tol = truth_tolerance(precision, np.atleast_1d(np.asarray(b)))
    np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                               atol=max(tol["atol"], SOLVER_ATOL_FLOOR),
                               err_msg=what)


def _check_solve(runs, key, jr, m, kernel_name, precision):
    """The port's ranks' result under ``key`` against the reference's
    ``jr`` (a sharded or single-device solve of the same m rows)."""
    ranks = [r[key] for r in runs["port"]]
    tr = ranks[0]
    # SPMD: every rank ends with the same global result, bitwise.
    for r in ranks[1:]:
        assert r["gamma"].tobytes() == tr["gamma"].tobytes()
        assert r["iters"] == tr["iters"] and r["rho"] == tr["rho"]
    X = runs["X"][:m]
    spec = torch_dist_ranks._spec(kernel_name)
    K = spec.kernel.gram(torch.as_tensor(X, dtype=torch.float64)).numpy()
    _within(_objective(tr["gamma"], K), _objective(jr["gamma"], K),
            precision, f"{key} objective")
    _within(np.asarray(tr["rho"]), np.asarray(jr["rho"]), precision,
            f"{key} rho")
    assert tr["converged"] == jr["converged"] is True
    assert abs(tr["iters"] - jr["iters"]) <= max(1, 0.1 * jr["iters"])
    g = tr["gamma"].astype(np.float64)
    assert g.shape == (m,)
    assert float(g.sum()) == pytest.approx(spec.total(), abs=1e-5)
    assert g.max() <= spec.upper(m) + 1e-7 and g.min() >= spec.lower(m) - 1e-7
    # The f-cache is K @ gamma over the rows the solve streams (rounded
    # to the tile dtype).
    Xr = round_to_tile(torch.as_tensor(X), precision).double()
    Kg = spec.kernel.gram(Xr).numpy() @ g
    np.testing.assert_allclose(tr["f"], Kg, **truth_tolerance(precision, Kg))


@pytest.mark.parametrize("mesh,kernel_name,precision", CELLS)
def test_distributed_solve_matches_jax(runs, mesh, kernel_name, precision):
    key = f"{mesh}/{kernel_name}-{precision}"
    _check_solve(runs, key, runs["jax"][key], MESHES[mesh]["m"],
                 kernel_name, precision)


@pytest.mark.parametrize("kernel_name", KERNELS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_padded_rows_match_the_single_device_solve(runs, kernel_name,
                                                   precision):
    _check_solve(runs, f"data4/pad-{kernel_name}-{precision}",
                 runs["jax"][f"single/pad-{kernel_name}-{precision}"], PAD_M,
                 kernel_name, precision)


@pytest.mark.parametrize("mesh,kernel_name,precision", CELLS)
def test_first_iterations_pick_the_reference_working_sets(
        runs, mesh, kernel_name, precision):
    """After FIRST_ITERS iterations the same rows have moved, by the same
    steps: within 1e-6 under rbf. Under linear the toy rows lie along a
    band (|x|^2 up to ~160), so a pair's denominator |x_a - x_b|^2 is a
    small difference of large kernel values and one f32 rounding moves
    its step by up to ~1e-3 relative: 1e-5 there."""
    key = f"{mesh}/{kernel_name}-{precision}-first"
    jr, tr = runs["jax"][key], runs["port"][0][key]
    jg = np.asarray(jr["gamma"], np.float32)
    assert tr["iters"] == jr["iters"] <= FIRST_ITERS
    g0 = tc.feasible_init(len(jg), torch_dist_ranks._spec(kernel_name))
    moved_t = tr["gamma"] != g0.numpy()
    moved_j = jg != g0.numpy()
    assert np.array_equal(moved_t, moved_j) and moved_t.any()
    np.testing.assert_allclose(tr["gamma"], jg, rtol=0,
                               atol=1e-6 if kernel_name == "rbf" else 1e-5)


@pytest.mark.parametrize("key", ["data4/rbf-f32", "data4/ledger-2048"])
def test_ledger_matches_jax_and_stays_within_the_pd_budget(runs, key):
    """The ledger's summary equals the reference's (the port records one
    iteration of its loop at run time, the reference its loop body at
    trace time), and the per-iteration bill is O(P d): the same at
    m = 256 and 2048, within tests/test_distributed.py's budget."""
    keys = ("init_bytes", "init_ops", "iteration_bytes", "iteration_ops")
    for r in runs["port"]:
        assert {k: r[key]["ledger"][k] for k in keys} == \
            {k: runs["jax"][key]["ledger"][k] for k in keys}
    bills = {runs["port"][0][k]["ledger"]["iteration_bytes"]
             for k in ("data4/rbf-f32", "data4/ledger-2048")}
    assert len(bills) == 1
    d = runs["X"].shape[1]
    assert 0 < bills.pop() <= 4 * RANKS * P * (d + 4) * 4 + 256
    assert runs["port"][0][key]["ledger"]["iteration_ops"] == 3


def test_ranks_build_the_solver_meshes(runs):
    for rank, r in enumerate(runs["port"]):
        plain, pod = r["meshes"][False], r["meshes"][True]
        assert plain["shape"] == {"data": RANKS, "model": 1}
        assert plain["data_axes"] == ("data",)
        assert plain["shard"] == rank
        assert pod["shape"] == {"pod": 2, "data": RANKS // 2, "model": 1}
        assert pod["data_axes"] == ("pod", "data")
        assert pod["coords"] == {"pod": rank // 2, "data": rank % 2,
                                 "model": 0}
        assert pod["shard"] == rank            # row-major over the axes


@pytest.mark.parametrize("recompute", [True, False])
def test_solver_stats_prev_matches_jax(recompute):
    rng = np.random.default_rng(5)
    m = 300
    spec = torch_dist_ranks._spec("rbf")
    hi, lo = spec.upper(m), spec.lower(m)
    gamma = rng.uniform(lo, hi, m).astype(np.float32)
    gamma[:40] = hi
    gamma[40:70] = lo
    gamma[70:120] = 0.0
    f = rng.standard_normal(m).astype(np.float32)
    valid = np.arange(m) < m - 7
    r1, r2 = np.float32(-0.3), np.float32(0.4)
    kw = dict(hi=hi, lo=lo, m=m, tol=1e-3)
    j = jstats.solver_stats_prev(
        jnp.asarray(gamma), jnp.asarray(f), jnp.asarray(r1), jnp.asarray(r2),
        recompute, valid=jnp.asarray(valid), **kw)
    t = tstats.solver_stats_prev(
        torch.as_tensor(gamma), torch.as_tensor(f), torch.tensor(r1),
        torch.tensor(r2), recompute, valid=torch.as_tensor(valid), **kw)
    np.testing.assert_allclose([float(x) for x in t], [float(x) for x in j],
                               rtol=1e-6, atol=1e-6)
    assert int(t[2]) == int(j[2]) and t[2].dtype == torch.int32


def test_solver_meshes_without_a_process_group():
    """No process group: one rank, identity collectives; the documented
    shapes over a rank list, and the reference's errors."""
    mesh, axes = make_solver_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and axes == ("data",)
    assert mesh.group(axes) is None
    mesh3, _ = make_solver_mesh(devices=[0, 1, 2])
    assert mesh3.shape == {"data": 3, "model": 1}
    pod, pod_axes = make_solver_mesh(multi_pod=True, devices=range(6))
    assert pod.shape == {"pod": 2, "data": 3, "model": 1}
    assert pod_axes == ("pod", "data") and pod.axis_rank(pod_axes) == 0
    with pytest.raises(RuntimeError, match="even device count"):
        make_solver_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="even device count"):
        make_solver_mesh(multi_pod=True, devices=[0, 1, 2])
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_test_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        mesh.group(("pod",))
    with pytest.raises(ValueError, match="mesh order"):
        pod.group(("data", "pod"))
    with pytest.raises(ValueError, match="not in the mesh"):
        make_solver_mesh(devices=[1, 2])


def test_one_rank_sharded_fit_and_ledger():
    """strategy="sharded" with no mesh and no process group: a one-rank
    mesh, identity collectives, the plain blocked solver's optimum, and
    one shard's O(P d) bill (the candidate gather plus the two stacked
    statistics vectors)."""
    X = make_toy(2, 256)[0]
    spec = torch_dist_ranks._spec("rbf")
    led = CollectiveLedger()
    a = repro_torch.fit(X, spec, strategy="sharded", P=P, tol=TOL,
                        device="cpu", ledger=led)
    b = repro_torch.fit(X, spec, strategy="blocked", P=P, tol=TOL,
                        device="cpu")
    assert bool(a.converged)
    K = spec.kernel.gram(torch.as_tensor(X, dtype=torch.float64)).numpy()
    _within(_objective(a.model.gamma.numpy(), K),
            _objective(b.model.gamma.numpy(), K), "f32", "objective")
    d = X.shape[1]
    assert led.summary() == {
        "init_bytes": 256 * d * 4 + 256 * 4 + 2 * (5 + 7) * 4,
        "init_ops": 6, "iteration_bytes": 2 * P * (4 + d) * 4 + (5 + 7) * 4,
        "iteration_ops": 3}
    assert led.calls == 0           # one rank: nothing ran on a backend


def test_a_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(RuntimeError, match=r"ranks \[1\] failed"):
        spawn_ranks(torch_dist_ranks.fail_on, 2, args=(dict(rank=1),),
                    timeout_s=RANKS_TIMEOUT_S, dir=str(tmp_path))


def test_ledger_phases_and_epochs():
    """The port's ledger bills one solve's iteration (phase None stops
    recording) and starts a new epoch at each solve's loop."""
    led = CollectiveLedger()
    comm = tstats.MeshComm(("data",), sizes=(4,), ledger=led)
    x = torch.zeros(5)
    comm.psum(x)
    led.set_phase("iter")
    comm.all_gather(torch.zeros((2, 3)), tiled=False)
    led.set_phase(None)
    comm.pmax(x)                    # not recorded
    led.set_phase("sweep")
    comm.pmax(torch.zeros(2))
    led.set_phase("iter")
    comm.psum(x)
    assert led.summary() == {"init_bytes": 20, "init_ops": 1,
                             "iteration_bytes": 96, "iteration_ops": 1,
                             "sweep_bytes": 8, "sweep_ops": 1}
    assert math.isclose(led.seconds, 0.0)

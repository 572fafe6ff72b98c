"""Rank functions the port's distributed tests spawn
(``repro_torch.launch.spawn_ranks``): each runs in its own process with a
process group, so it must be importable by name. This module imports
torch and the port only (no JAX, no pytest): a rank pays for nothing
else, and the card's machine, which has no JAX, can import it.

Each function takes ``(rank, world, job)`` and returns plain numbers and
numpy arrays.
"""
from __future__ import annotations

import torch


def _spec(kernel_name: str, d: int = 2):
    """The tests' slab: rbf(0.5) or linear on the toy rows; "rbf-d" is
    rbf(1/d), the width scaled with d."""
    from repro_torch.core import SlabSpec, linear, rbf
    kern = {"rbf": rbf(0.5), "linear": linear(),
            "rbf-d": rbf(1.0 / d)}[kernel_name]
    return SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=kern)


def _summary(res) -> dict:
    return {"gamma": res.model.gamma.cpu().numpy(),
            "f": None if res.f is None else res.f.cpu().numpy(),
            "rho": [float(res.model.rho1), float(res.model.rho2)],
            "iters": int(res.iters), "converged": bool(res.converged)}


def solve_cells(rank: int, world: int, job: dict) -> dict:
    """``solve_blocked_distributed`` for every cell (kernel, precision, m,
    max_outer) of every mesh of ``job["meshes"]``, each with a ledger,
    keyed "<mesh>/<cell>"; and the meshes ``make_solver_mesh`` builds
    over the world."""
    torch.set_num_threads(1)     # the ranks share the host's cores
    from repro_torch.core import solve_blocked_distributed
    from repro_torch.core.engine import CollectiveLedger
    from repro_torch.launch import make_solver_mesh, make_test_mesh
    out = {}
    for name, mj in job["meshes"].items():
        mesh = make_test_mesh(tuple(mj["shape"]), tuple(mj["axes"]))
        for key, (kname, precision, m, max_outer) in mj["cells"].items():
            led = CollectiveLedger()
            res = solve_blocked_distributed(
                torch.as_tensor(job["X"][:m]), _spec(kname), mesh,
                data_axes=tuple(mj["data_axes"]), P_pairs=job["P"],
                tol=job["tol"], max_outer=max_outer, precision=precision,
                ledger=led, device="cpu")
            out[f"{name}/{key}"] = dict(_summary(res), ledger=led.summary())
    meshes = {}
    for multi_pod in (False, True):
        mesh, axes = make_solver_mesh(multi_pod=multi_pod)
        meshes[multi_pod] = dict(shape=mesh.shape, data_axes=axes,
                                 coords=mesh.coords(),
                                 shard=mesh.axis_rank(axes))
    out["meshes"] = meshes
    return out


def fail_on(rank: int, world: int, job: dict) -> int:
    """Raises on rank ``job["rank"]``; the others return their rank."""
    if rank == job["rank"]:
        raise ValueError(f"rank {rank} failed on purpose")
    return rank


def sharded_paths(rank: int, world: int, job: dict) -> dict:
    """The rest of the sharded surface on a ("data",) mesh:
    ``sharded_raw_scores``, a warm refit through ``fit_update(mesh=)``,
    ``solve_sharded_shrinking`` for every case of ``job["shrink"]`` (its
    rounds logged: distributed solves, and the local repack solve on the
    first rank) and the sharded scorer for every request size."""
    import repro_torch
    import repro_torch.core.distributed_smo as dsmo
    import repro_torch.core.shrinking as shrinking
    from repro_torch.core import sharded_raw_scores, solve_sharded_shrinking
    from repro_torch.core.engine import CollectiveLedger, SolverArtifact
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.serve import pack_model
    torch.set_num_threads(1)     # the ranks share the host's cores
    from repro_torch.launch import make_test_mesh
    mesh = make_test_mesh((world,), ("data",))
    axes = ("data",)
    spec = _spec("rbf")
    out = {}
    X = torch.as_tensor(job["X"])
    g = torch.as_tensor(job["gamma"])
    out["raw"] = {p: sharded_raw_scores(X, g, spec.kernel, mesh,
                                        data_axes=axes, precision=p).numpy()
                  for p in ("f32", "bf16")}

    art = SolverArtifact.load(job["artifact"])
    st = {}
    led = CollectiveLedger()
    res = repro_torch.fit_update(art, job["X_new"], tol=job["tol"],
                                 mesh=mesh, data_axes=axes, stats_out=st,
                                 ledger=led, device="cpu")
    out["warm"] = dict(_summary(res), stats=dict(st), ledger=led.summary())

    rounds = []
    real_local, real_dist = shrinking.solve_blocked, \
        dsmo.solve_blocked_distributed

    def local_spy(Xa, *a, **k):
        r = real_local(Xa, *a, **k)
        rounds.append(("repack", int(Xa.shape[0]), int(r.iters)))
        return r

    def dist_spy(*a, **k):
        r = real_dist(*a, **k)
        rounds.append(("distributed", int(r.iters)))
        return r

    shrinking.solve_blocked = local_spy
    dsmo.solve_blocked_distributed = dist_spy
    try:
        Xs = torch.as_tensor(job["X_shrink"])
        for key, kw in job["shrink"].items():
            kw = dict(kw)
            kname, precision = kw.pop("kernel"), kw.pop("precision")
            rounds.clear()
            res = solve_sharded_shrinking(
                Xs, _spec(kname), mesh, data_axes=axes, P_pairs=job["P"],
                tol=job["shrink_tol"], precision=precision, device="cpu",
                **kw)
            out[f"shrink/{key}"] = dict(
                _summary(res), rounds=list(rounds),
                callers_rows=bool(torch.equal(res.model.X, Xs)))
    finally:
        shrinking.solve_blocked = real_local
        dsmo.solve_blocked_distributed = real_dist

    sv = job["served"]
    model = OCSSVMModel(gamma=torch.as_tensor(sv["gamma"]),
                        rho1=torch.tensor(sv["rho1"]),
                        rho2=torch.tensor(sv["rho2"]),
                        X=torch.as_tensor(sv["X"]), spec=spec)
    for precision in ("f32", "bf16"):
        sm = pack_model(model, precision=precision)
        scorer = sm.scorer(mesh=mesh)
        out[f"scores/{precision}"] = {
            n: (scorer.score(job["queries"][:n]),
                sm.score(job["queries"][:n]), scorer.bucket_used(n))
            for n in job["requests"]}
        out[f"scores/{precision}/tensor"] = scorer.score(
            torch.as_tensor(job["queries"][:100])).numpy()
        scorer.warmup()
        out[f"scores/{precision}/warmed"] = sorted(scorer.warmed_buckets)
    return out


def card_fit(rank: int, world: int, job: dict) -> dict:
    """``fit(strategy="distributed")`` on ``cuda:0`` (every rank of the
    job shares the one card), with fupdate's launch count."""
    import repro_torch
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.launch import make_solver_mesh
    torch.cuda.set_device(0)
    mesh, axes = make_solver_mesh()
    fup.FUPDATE.reset_counts()
    res = repro_torch.fit(job["X"], _spec("rbf-d", job["X"].shape[1]),
                          strategy="distributed", mesh=mesh, data_axes=axes,
                          P=8, tol=1e-3, precision=job["precision"])
    torch.cuda.synchronize()
    return dict(_summary(res), launches=fup.FUPDATE.launches,
                device=str(res.model.gamma.device))


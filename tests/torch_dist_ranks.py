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



# -- the sharded LM training step (tests/test_torch_lm_dist.py and
# chip_smoke.py [lm-dist]) ------------------------------------------------

def lm_dist_cfg(case: dict):
    """A case's ArchConfig: the arch (reduced unless ``reduced`` is
    False) with ``overrides``; an MoE arch's capacity factor is E, so the
    global path drops no token (the JAX package's MoE tests do the same)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(case["arch"])
    if case.get("reduced", True):
        cfg = cfg.reduced()
    over = dict(case.get("overrides", {}))
    if cfg.n_experts:
        over.setdefault("capacity_factor", float(cfg.n_experts))
    return dataclasses.replace(cfg, **over)


def aux_groups(case: dict) -> int:
    """How many per-shard aux losses the sharded step averages: the data
    shards of the "tp" layout's batch (GShard's per-group balance loss);
    1 under "fsdp", where the global path runs on the gathered tokens."""
    import math
    if case["layout"] != "tp":
        return 1
    shape = dict(zip(case["mesh"][1], case["mesh"][0]))
    axes = [ax for ax in ("pod", "data") if ax in shape]
    while axes and case["batch"] % math.prod(shape[a] for a in axes):
        axes = axes[:-1]
    return math.prod(shape[a] for a in axes)


class grouped_aux:
    """Within it, the single-device forward's MoE aux is the mean of the
    aux of each of ``n`` equal batch groups (its output stays the global
    call's): the sharded "tp" step's aux, on one device."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        import torch
        from repro_torch.models import transformer
        self.real = real = transformer.moe_forward
        n = self.n

        def moe_forward(params, x, **kw):
            y, aux = real(params, x, **kw)
            if n > 1:
                aux = torch.stack([real(params, xg, **kw)[1]
                                   for xg in x.chunk(n, 0)]).mean()
            return y, aux
        transformer.moe_forward = moe_forward
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe_forward = self.real


def lm_oracle(case: dict, device, seed: int):
    """The port's single-device step on the case's parameters and
    batches: (per-step metrics, the final TrainState)."""
    import torch
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as tts
    cfg = lm_dist_cfg(case)
    dev = torch.device(device)
    state = tts.init_train_state(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    pipe = SyntheticPipeline(cfg, batch=case["batch"], seq_len=case["seq"],
                             seed=seed, device=dev)
    step = tts.make_train_step(cfg, **case.get("step_kw", {}))
    metrics = []
    with grouped_aux(aux_groups(case)):
        for _ in range(case["steps"]):
            state, m = step(state, pipe.next_batch())
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _slab_kernels() -> dict:
    """The three slab kernels' wrappers, by name, their counts set to 0."""
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.gram import ops as gram_ops
    kernels = {"fupdate": fup.FUPDATE, "decision": dec.DECISION,
               "gram": gram_ops.GRAM}
    for k in kernels.values():
        k.reset_counts()
    return kernels


def _scan_kernels() -> dict:
    """The scan kernels' wrappers (Mamba, RWKV6), by name, their counts
    set to 0."""
    from repro_torch.kernels.scan import ops as sops
    kernels = {k.entry[:-len("_launch")]: k for k in sops.KERNELS}
    for k in kernels.values():
        k.reset_counts()
    return kernels


def _take_counts(kernels: dict, into: dict) -> dict:
    """Adds each kernel's launches since its count was last set to 0 to
    ``into`` (returned), then sets the counts to 0 again."""
    for name, k in kernels.items():
        into[name] = into.get(name, 0) + k.launches
        k.reset_counts()
    return into


def lm_dist_steps(rank: int, world: int, job: dict) -> dict:
    """The sharded train step for each case of ``job["cases"]``: the
    parameters drawn from ``job["seed"]`` on ``job["device"]`` (every rank
    the same; on CUDA the first card, or card ``rank`` with
    ``job["card_per_rank"]``), sharded onto the case's mesh (``make_test_mesh``), the
    optimizer started on the shards, ``steps`` steps of the synthetic
    batches (seed ``job["seed"]``). Per case: each step's metrics, ms,
    collective calls and host ms in them, the peak memory, the ledger's
    summary and its op counts over the steps; with ``params``, the first
    rank also returns the parameters after the steps, gathered (numpy f32,
    ``leaves`` order); with ``plain``, the single-device step's too
    (``_plain_steps``); with ``trace`` and a ``job["tracer"]`` (a
    function that runs a one-step callable under the profiler), one more
    step traced ("trace", and "plain_trace" with ``plain``). Under
    "launches": this rank's launches of each slab kernel on the sharded
    path over all the cases (the counts set to 0 at the start and read
    before any single-device run); under "oracle_launches", the
    single-device runs' (``plain``), counted apart. Under "entered": the
    host clock (``time.time``) when the rank function began."""
    import time
    entered = time.time()
    import types
    import torch
    from repro_torch.api import resolve_device
    from repro_torch.core.engine import CollectiveLedger
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding import make_constrain
    from repro_torch.sharding.state import shard_params, unshard_train_state
    from repro_torch.train import train_step as tts
    from repro_torch.utils.tree import leaves
    kernels, scans = _slab_kernels(), _scan_kernels()
    path, oracle = dict.fromkeys(kernels, 0), dict.fromkeys(kernels, 0)
    torch.set_num_threads(job.get("threads", 1))
    dev = resolve_device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(rank if job.get("card_per_rank") else 0)
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    out = {"entered": entered}
    for case in job["cases"]:
        _take_counts(scans, {})   # this case's sharded run only
        cfg = lm_dist_cfg(case)
        mesh = make_test_mesh(tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        led = CollectiveLedger()
        led.set_phase(None)
        constrain = make_constrain(mesh, fsdp=case["fsdp"],
                                   layout=case["layout"], ledger=led)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        state = tts.init_train_state(cfg, shard_params(init_params(
            cfg, torch.Generator(device=dev).manual_seed(job["seed"]),
            device=dev), cfg, constrain))
        pipe = SyntheticPipeline(cfg, batch=case["batch"],
                                 seq_len=case["seq"], seed=job["seed"],
                                 device=dev)
        step = tts.make_train_step(cfg, constrain=constrain,
                                   **case.get("step_kw", {}))
        metrics, ms, coll_ms, calls = [], [], [], []
        led.set_phase("step")
        for _ in range(case["steps"]):
            batch = pipe.next_batch()
            c0, n0 = led.seconds, led.calls
            t0 = sync()
            state, m = step(state, batch)
            m = {k: float(v) for k, v in m.items()}
            ms.append(1e3 * (sync() - t0))
            coll_ms.append(1e3 * (led.seconds - c0))
            calls.append(led.calls - n0)
            metrics.append(m)
        led.set_phase(None)
        tracer = job.get("tracer") if case.get("trace") else None
        if tracer is not None:
            def one_step():
                nonlocal state
                state, m = step(state, pipe.next_batch())
                float(m["loss"])
                return types.SimpleNamespace(iters=1)
            trace = tracer(one_step)
        _take_counts(kernels, path)
        ops: dict = {}
        for r in led.records:
            ops[r.op] = ops.get(r.op, 0) + 1
        res = {"scan_launches": _take_counts(scans, {}),
               "metrics": metrics, "ms": ms, "ledger": led.summary(),
               "ops": ops, "collective_ms": coll_ms,
               "collective_calls": calls,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None)}
        if tracer is not None:
            res["trace"] = trace
        if case.get("params"):
            full_state = unshard_train_state(state, cfg, constrain)
            if rank == 0:
                res["params"] = [t.detach().float().cpu().numpy()
                                 for t in leaves(full_state.params)]
            del full_state
        del state, step
        if case.get("plain"):
            res.update(_plain_steps(case, cfg, dev, job["seed"], sync,
                                    tracer))
            _take_counts(kernels, oracle)
        out[case["key"]] = res
    out["launches"], out["oracle_launches"] = path, oracle
    return out


def _plain_steps(case: dict, cfg, dev, seed: int, sync,
                 tracer=None) -> dict:
    """The single-device ``make_train_step`` on the case's parameters and
    batches, timed as ``lm_dist_steps`` times the sharded one: each
    step's ms and metrics, the peak memory and, with ``tracer``, one more
    step traced ("plain_" keys)."""
    import types
    import torch
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as tts
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = tts.init_train_state(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    pipe = SyntheticPipeline(cfg, batch=case["batch"], seq_len=case["seq"],
                             seed=seed, device=dev)
    step = tts.make_train_step(cfg, **case.get("step_kw", {}))
    ms, metrics = [], []
    for _ in range(case["steps"]):
        batch = pipe.next_batch()
        t0 = sync()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append(1e3 * (sync() - t0))
    out = {"plain_ms": ms, "plain_metrics": metrics,
           "plain_peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                              if cuda else None)}
    if tracer is not None:
        def one_step():
            nonlocal state
            state, m = step(state, pipe.next_batch())
            float(m["loss"])
            return types.SimpleNamespace(iters=1)
        out["plain_trace"] = tracer(one_step)
    del state, step
    return out


def lm_dist_functions(rank: int, world: int, job: dict) -> dict:
    """The sharded functions on this rank's shards of ``job``'s numpy
    inputs, their outputs gathered (returned by the first rank):
    ``mlp_forward_tp`` and ``moe_forward`` on a (2, 2) mesh per
    ``job["cells"]``, ``psum_compressed`` on a (4, 1) mesh; and a
    checkpoint of a sharded reduced-llama state saved on (2, 2)
    (``save_sharded`` into ``job["ckpt"]``, after one step) and
    restored with ``reshard_checkpoint`` onto (4, 1), (1, 4) and, on the
    first rank, (1, 1): each restored leaf (and ``reshard_live``'s of the
    saved full state) against ``shard`` of the saved state, bitwise."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.checkpoint.reshard import (reshard_checkpoint,
                                                reshard_live, save_sharded,
                                                shardings_for)
    from repro_torch.core.engine import CollectiveLedger, MeshComm
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.layers import mlp_forward_tp
    from repro_torch.models.moe import moe_forward
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.compression import (init_error_state,
                                               psum_compressed)
    from repro_torch.sharding import (NamedSharding, make_constrain, shard,
                                      spec_for_param, unshard)
    from repro_torch.sharding.specs import P, map_specs
    from repro_torch.sharding.state import (shard_train_state, state_specs,
                                            unshard_train_state)
    from repro_torch.train import train_step as tts
    from repro_torch.utils.tree import Stacked, leaves, map_tree
    torch.set_num_threads(1)
    out: dict = {}
    T = torch.as_tensor

    # -- a sharded state saved on (2, 2), restored onto other meshes -----
    cfg = lm_dist_cfg({"arch": "llama3.2-3b"})
    mesh = make_test_mesh((2, 2), ("data", "model"))
    constrain = make_constrain(mesh, fsdp=True)
    full = tts.init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    state = shard_train_state(full, cfg, constrain)
    step = tts.make_train_step(cfg, constrain=constrain, peak_lr=1e-3,
                               warmup_steps=1, total_steps=10)
    pipe = SyntheticPipeline(cfg, batch=4, seq_len=16, device="cpu")
    for _ in range(2):
        state, _ = step(state, pipe.next_batch())
    specs = state_specs(state, cfg, constrain.sharding)
    save_sharded(job["ckpt"], 2, state,
                 map_specs(lambda s: NamedSharding(mesh, s), specs))
    saved = unshard_train_state(state, cfg, constrain)
    like = full

    def digest(t):
        if isinstance(t, Stacked):
            t = torch.stack(list(t))
        return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
    out["saved"] = {}
    _walk(saved, (), lambda path, t: out["saved"].__setitem__(
        "/".join(path), digest(t)))
    targets = [((4, 1), ("data", "model")), ((1, 4), ("data", "model"))]
    if rank == 0:
        targets.append(((1, 1), ("data", "model")))
    out["reshard"] = {}
    for shape, axes in targets:
        if shape == (1, 1):
            from repro_torch.launch.mesh import SolverMesh
            m = SolverMesh(axes, shape, (rank,), rank)
        else:
            m = make_test_mesh(shape, axes)
        back = reshard_checkpoint(job["ckpt"], 2, like, m)
        want = map_tree(lambda t, s: shard(t, s.spec, m), saved,
                        shardings_for(like, m))
        live = reshard_live(saved, m)
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   and torch.equal(c, b) for a, b, c in zip(
                       leaves(back), leaves(want), leaves(live)))
        out["reshard"][f"{shape[0]}x{shape[1]}"] = same

    # -- mlp_forward_tp and the MoE paths on (2, 2) -----------------------
    def run(fn, params, x, fsdp, names, moe_layout="psum"):
        led = CollectiveLedger()
        led.set_phase("step")
        constrain = make_constrain(mesh, fsdp=fsdp, ledger=led)
        sh = constrain.sharding
        specs = {k: spec_for_param([names, k], v.shape, mesh, fsdp=fsdp,
                                   moe_layout=moe_layout)
                 for k, v in params.items()}
        local = {k: shard(T(v), specs[k], mesh) for k, v in params.items()}
        xl = sh.shard_batch({"x": T(x)})["x"]
        y, aux = fn(local, xl, constrain, sh, specs)
        y = unshard(y, P(sh.split), mesh)
        ops = sorted({r.op for r in led.records})
        return {"y": y.numpy(), "aux": None if aux is None else float(aux),
                "ops": ops}

    for cell in job["cells"]:
        kind, fsdp = cell["kind"], cell["fsdp"]
        if kind == "mlp":
            out[cell["key"]] = run(
                lambda p, x, c, sh, sp: (mlp_forward_tp(p, x, "swiglu", sh,
                                                        sp), None),
                job["mlp"], job["x"], fsdp, "mlp")
        else:
            out[cell["key"]] = run(
                lambda p, x, c, sh, sp: moe_forward(
                    p, x, n_experts=job["E"], top_k=2,
                    capacity_factor=float(job["E"]), mlp_type="swiglu",
                    impl=kind, constrain=c, specs=sp),
                job["moe"], job["x"], fsdp, "moe", moe_layout=kind)

    # -- psum_compressed over the data axis of a (4, 1) mesh --------------
    m41 = make_test_mesh((4, 1), ("data", "model"))
    g = T(job["g"])
    spec = P("data", None)
    local = {"w": shard(g, spec, m41)}
    mean, err = psum_compressed(local, init_error_state(local),
                                MeshComm(("data",), mesh=m41))
    out["compressed"] = {"mean": unshard(mean["w"], spec, m41).numpy(),
                         "err": unshard(err["w"], spec, m41).numpy()}
    return out


def _walk(tree, path, fn):
    """``fn(path, leaf)`` over a TrainState-like tree in the checkpoint
    manager's order (a ``Stacked`` one leaf)."""
    from repro_torch.utils.tree import Stacked
    if isinstance(tree, Stacked) or not isinstance(tree, (dict, list, tuple)):
        fn(path, tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (str(k),), fn)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _walk(getattr(tree, f), path + (f,), fn)
    else:
        for i, t in enumerate(tree):
            _walk(t, path + (str(i),), fn)


def lm_dist_all(rank: int, world: int, job: dict) -> dict:
    """``lm_dist_functions`` then ``lm_dist_steps`` (one spawn)."""
    return {"functions": lm_dist_functions(rank, world, job),
            "steps": lm_dist_steps(rank, world, job)}


def lm_dist_loaded(rank: int, world: int, job: dict) -> dict:
    """``lm_dist_steps``, then the JAX modules this rank has loaded."""
    import sys
    out = lm_dist_steps(rank, world, job)
    return {"steps": out, "loaded": sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))}


def collectives_on_card(rank: int, world: int) -> dict:
    """Every collective of the sharded path on CUDA tensors of a
    (world, 1) mesh ("data" = the ranks), each against the arithmetic on
    one tensor; returns the names of those that disagree."""
    import torch
    from repro_torch.api import resolve_device
    from repro_torch.core.engine import MeshComm
    from repro_torch.launch import make_test_mesh
    from repro_torch.sharding.collectives import ShardCtx
    torch.cuda.set_device(0)
    dev = resolve_device("cuda")
    mesh = make_test_mesh((world, 1), ("data", "model"))
    comm = MeshComm(("data",), mesh=mesh)
    sh = ShardCtx(mesh, layout="tp")
    n = world
    # rank r's operand: small integers, exact in f32
    full = torch.arange(n * 4 * 6, dtype=torch.float32,
                        device=dev).reshape(n * 4, 6)
    mine = full[rank * 4:(rank + 1) * 4]
    total = sum(full[r * 4:(r + 1) * 4] for r in range(n))
    failed = []

    def same(name, got, want):
        if not (got.is_cuda and torch.equal(got, want)):
            failed.append(name)

    same("psum", comm.psum(mine), total)
    same("all_gather dim 0", comm.all_gather(mine), full)
    same("all_gather dim 1", comm.all_gather(mine, dim=1),
         torch.cat([full[r * 4:(r + 1) * 4] for r in range(n)], dim=1))
    same("reduce_scatter", comm.reduce_scatter(full, dim=0),
         sum(full for _ in range(n))[rank * 4:(rank + 1) * 4])
    blocks = [full[r * 4:(r + 1) * 4] + 100 * rank for r in range(n)]
    a2a = comm.all_to_all(torch.cat(blocks), split_dim=0, concat_dim=1)
    same("all_to_all", a2a, torch.cat(
        [full[rank * 4:(rank + 1) * 4] + 100 * r for r in range(n)], dim=1))
    # the autograd operators and their backward passes
    x = mine.clone().requires_grad_(True)
    y = sh.gather(x, ("data",))                   # batch axis: split
    y.backward(torch.ones_like(y))
    same("gather", y.detach(), full)
    same("gather backward (reduce-scatter)", x.grad,
         torch.full_like(mine, float(n)))
    x = mine.clone().requires_grad_(True)
    sh.copy_to(x, ("data",)).backward(torch.ones_like(x))
    same("copy_to backward (psum)", x.grad, torch.full_like(mine, float(n)))
    x = mine.clone().requires_grad_(True)
    y = sh.reduce_from(x, ("data",))
    y.backward(torch.ones_like(y))
    same("reduce_from", y.detach(), total)
    same("reduce_from backward (identity)", x.grad, torch.ones_like(mine))
    x = mine.clone().requires_grad_(True)
    y = sh.pmean(x, ("data",))
    y.backward(torch.ones_like(y))
    same("pmean", y.detach(), total / n)
    same("pmean backward", x.grad, torch.full_like(mine, 1.0 / n))
    return {"device": mine.device.type, "failed": failed}


# -- sharded LM serving (tests/test_torch_lm_serve_dist.py and
# chip_smoke.py [lm-serve-dist]) ------------------------------------------

def serve_inputs(cfg, batch: int, prompt: int, seed: int, device) -> dict:
    """A prompt batch of ``prompt`` positions for the arch (its frontend
    stubs too), drawn on the host from ``seed`` and moved to ``device``:
    every rank and the oracle get the same global inputs."""
    import torch
    g = torch.Generator().manual_seed(seed)
    kw = {}
    if cfg.frontend == "audio":
        kw["embeds"] = torch.randn((batch, prompt, cfg.d_model), generator=g)
    else:
        nv = cfg.n_frontend_tokens
        kw["tokens"] = torch.randint(0, cfg.vocab_size, (batch, prompt - nv),
                                     generator=g, dtype=torch.int32)
        if nv:
            kw["vision_embeds"] = torch.randn((batch, nv, cfg.d_model),
                                              generator=g)
    return {k: v.to(device) for k, v in kw.items()}


def _generate(cfg, params, cache, inputs, steps: int, prefill, decode, sync,
              led=None, forced=None) -> dict:
    """Prefill then ``steps`` greedy decode steps: each step's logits of
    the last position (numpy f32, the whole batch), the tokens (each
    step's argmax), the cache after the last step, prefill ms and each
    decode step's ms; with ``led`` (a CollectiveLedger), each decode
    step's collective calls, host ms and bytes. ``forced``: the tokens
    (B, steps + 1) to feed in place of the argmax (another run's, so both
    runs see the same inputs at every step)."""
    import torch
    out = {"logits": [], "ms": [], "calls": [], "coll_ms": [], "bytes": []}
    if led is not None:
        led.set_phase("prefill")
    t0 = sync()
    logits, cache = prefill(params, cache, inputs)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out["prefill_ms"] = 1e3 * (sync() - t0)
    out["logits"].append(logits[:, -1].float().cpu().numpy())
    toks = [tok]
    for i in range(steps):
        if forced is not None:
            tok = torch.as_tensor(forced[:, i:i + 1], device=tok.device)
        if led is not None:
            led.set_phase("decode")
            c0, n0, b0 = led.seconds, led.calls, led.phase_bytes("decode")
        t0 = sync()
        logits, cache = decode(params, cache, tok)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out["ms"].append(1e3 * (sync() - t0))
        if led is not None:
            out["calls"].append(led.calls - n0)
            out["coll_ms"].append(1e3 * (led.seconds - c0))
            out["bytes"].append(led.phase_bytes("decode") - b0)
        out["logits"].append(logits[:, -1].float().cpu().numpy())
        toks.append(tok)
    if led is not None:
        led.set_phase(None)
    out["tokens"] = torch.cat(toks, dim=1).cpu().numpy()
    out["cache"] = cache
    return out


def _case_inputs(case: dict, cfg, seed: int, device) -> dict:
    """The case's global inputs: its own (numpy, ``inputs``) or
    ``serve_inputs`` from ``seed``."""
    import torch
    if "inputs" in case:
        return {k: torch.as_tensor(v, device=device)
                for k, v in case["inputs"].items()}
    return serve_inputs(cfg, case["batch"], case["prompt"], seed, device)


def lm_serve_oracle(case: dict, device, seed: int, forced=None,
                    upcast: bool = False) -> dict:
    """The port's single-device prefill + greedy decode of the case (fed
    ``forced`` tokens if given): the parameters drawn from ``seed``, the
    inputs from ``seed + 1`` (``_case_inputs``); ``_generate``'s record of
    the last of ``case["runs"]`` runs (default 1; the first warms the
    device up), its cache's leaves as numpy (layer order, field order).
    With ``upcast``, the drawn parameters are cast to f32 and the run is
    f32 throughout: the case's model without the roundings of its own
    dtype, a reference for its runs in that dtype."""
    import dataclasses
    import time
    import torch
    from repro_torch.models.transformer import (Decoder, init_cache,
                                                init_params)
    from repro_torch.train.serve_step import make_decode, make_prefill
    cfg = lm_dist_cfg(case)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    if upcast:
        def f32(m):
            t = {k: v.float() for k, v in m.named_parameters(recurse=False)}
            t.update({k: {n: w.float() for n, w in c.items()}
                      for k, c in m.named_children()})
            return t
        cfg = dataclasses.replace(cfg, param_dtype="float32")
        params = Decoder(cfg, {
            "embed": params.embed.float(),
            "final_norm": params.final_norm.float(),
            "unembed": params.unembed.float(),
            "layers": [f32(m) for m in params.layers]})
    for _ in range(case.get("runs", 1)):
        cache = init_cache(cfg, case["batch"], case["cache_len"],
                           device=dev)
        out = _generate(cfg, params, cache, _case_inputs(case, cfg,
                                                         seed + 1, dev),
                        case["steps"], make_prefill(cfg), make_decode(cfg),
                        sync, forced=forced)
    del params, cache
    out["cache"] = [t.float().cpu().numpy() for st in out["cache"]["layers"]
                    for t in st]
    return out


def lm_serve_steps(rank: int, world: int, job: dict) -> dict:
    """Sharded prefill + greedy decode for each case of ``job["cases"]``
    on its mesh (``make_test_mesh``): this rank's parameters drawn by
    ``init_params_sharded`` from ``job["seed"]`` on ``job["device"]``
    (on CUDA the first card, or card ``rank`` with
    ``job["card_per_rank"]``), its cache shard from
    ``init_cache_sharded``, the case's inputs (``serve_inputs``, seed + 1).
    Per case: ``_generate``'s record of the last of ``runs`` runs
    (default 1; the first warms the collectives and kernels up: its
    prefill ms and decode ms under "first", whether every run gave the
    same tokens under "repeat_equal"; the cache as this rank's leaves,
    numpy; with ``no_cache``, left out), the draw's seconds and peak
    memory, the ledger's op counts and the peak memory; with ``plain``,
    on the first rank, the single-device run of the case after it in
    this process (on this rank's card), fed the sharded run's tokens
    ("plain"), and with ``truth`` besides, the same run in f32 on the
    same parameters cast up (``lm_serve_oracle``'s ``upcast``, "truth"); with ``unshard``, the full cache gathered back
    (``unshard_cache``, "full_cache"). Under "launches": this rank's
    launches of each slab kernel on the sharded path over all the cases
    (the counts set to 0 at the start and read before any single-device
    run); under "oracle_launches", the single-device runs', counted
    apart. Under "entered": the host clock (``time.time``) when the rank
    function began (the parent reads the process start from it); each
    case's "case_s": its wall seconds in this rank, its single-device runs
    included."""
    import time
    entered = time.time()
    import torch
    from repro_torch.api import resolve_device
    from repro_torch.core.engine import CollectiveLedger
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.transformer import init_params_sharded
    from repro_torch.sharding import make_constrain
    from repro_torch.sharding.state import init_cache_sharded, unshard_cache
    from repro_torch.train.serve_step import make_decode, make_prefill
    kernels, scans = _slab_kernels(), _scan_kernels()
    path, oracle = dict.fromkeys(kernels, 0), dict.fromkeys(kernels, 0)
    torch.set_num_threads(job.get("threads", 1))
    dev = resolve_device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(rank if job.get("card_per_rank") else 0)
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    out = {"entered": entered}
    for case in job["cases"]:
        case_t0 = time.perf_counter()
        _take_counts(scans, {})   # this case's sharded run only
        cfg = lm_dist_cfg(case)
        mesh = make_test_mesh(tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        led = CollectiveLedger()
        led.set_phase(None)
        constrain = make_constrain(mesh, fsdp=case["fsdp"],
                                   layout=case.get("layout", "tp"),
                                   ledger=led)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = sync()
        params = init_params_sharded(
            cfg, torch.Generator(device=dev).manual_seed(job["seed"]),
            constrain)
        draw_s = sync() - t0
        draw_gib = (torch.cuda.max_memory_allocated() / 2**30
                    if cuda else None)
        runs = []
        for _ in range(case.get("runs", 1)):
            cache = init_cache_sharded(cfg, case["batch"],
                                       case["cache_len"], constrain,
                                       device=dev)
            runs.append(_generate(cfg, params, cache, _case_inputs(
                case, cfg, job["seed"] + 1, dev), case["steps"],
                make_prefill(cfg, constrain=constrain),
                make_decode(cfg, constrain=constrain), sync, led))
        _take_counts(kernels, path)
        res = runs[-1]
        res["scan_launches"] = _take_counts(scans, {})
        if case.get("unshard"):
            full = unshard_cache(res["cache"], cfg, constrain)
            res["full_cache"] = [t.float().cpu().numpy()
                                 for st in full["layers"] for t in st]
            del full
        res["first"] = {"prefill_ms": runs[0]["prefill_ms"],
                        "ms": runs[0]["ms"]}
        res["repeat_equal"] = all(
            (r["tokens"] == res["tokens"]).all() for r in runs)
        del runs
        res["cache"] = (None if case.get("no_cache") else
                        [t.float().cpu().numpy()
                         for st in res["cache"]["layers"] for t in st])
        ops: dict = {}
        for r in led.records:
            ops[r.op] = ops.get(r.op, 0) + 1
        res.update(draw_s=draw_s, draw_gib=draw_gib, ops=ops,
                   peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                             if cuda else None))
        del params, cache
        if case.get("plain") and rank == 0:
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            plain = lm_serve_oracle(case, dev, job["seed"],
                                    forced=res["tokens"])
            plain["cache"] = None
            plain["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else None)
            res["plain"] = plain
            if case.get("truth"):
                res["truth"] = lm_serve_oracle(
                    dict(case, runs=1), dev, job["seed"],
                    forced=res["tokens"], upcast=True)
                res["truth"]["cache"] = None
            _take_counts(kernels, oracle)
        res["case_s"] = time.perf_counter() - case_t0
        out[case["key"]] = res
    out["launches"], out["oracle_launches"] = path, oracle
    return out


def draw_parity(rank: int, world: int, job: dict) -> dict:
    """For each case of ``job["cases"]`` (arch, mesh, layout, fsdp):
    whether this rank's ``init_params_sharded`` is bitwise (values and
    dtypes, leaf for leaf) ``shard_params(init_params(...))`` of the same
    seed, and the number of leaves."""
    import torch
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.transformer import (init_params,
                                                init_params_sharded)
    from repro_torch.sharding import make_constrain
    from repro_torch.sharding.state import shard_params
    from repro_torch.utils.tree import leaves
    torch.set_num_threads(1)
    out = {}
    for case in job["cases"]:
        cfg = lm_dist_cfg(case)
        mesh = make_test_mesh(tuple(case["mesh"][0]), tuple(case["mesh"][1]))
        constrain = make_constrain(mesh, fsdp=case["fsdp"],
                                   layout=case["layout"])
        got = leaves(init_params_sharded(
            cfg, torch.Generator().manual_seed(job["seed"]), constrain))
        want = leaves(shard_params(init_params(
            cfg, torch.Generator().manual_seed(job["seed"]), device="cpu"),
            cfg, constrain))
        out[case["key"]] = (
            len(got) == len(want) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) for a, b in zip(got, want)),
            len(got), sum(a.numel() for a in got))
    return out


def ft_loop_on_mesh(rank: int, world: int, job: dict) -> dict:
    """``FaultTolerantLoop`` over the sharded train step of reduced llama
    (f32, AdamW) on a (2, 2) mesh, ``job["steps"]`` steps, a checkpoint
    every 2 (``save_sharded`` into ``job["ckpt"]``): once uninterrupted,
    once with a failure injected before each step of ``job["fail"]``
    (every rank fails there). Returns the restarts, whether the two final
    states are bitwise equal on this rank, and (the first rank) sha256
    digests of the full final state's leaves, keyed by the checkpoint's
    paths, and of the port's own restore of the last checkpoint."""
    import hashlib
    import os
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.transformer import init_params_sharded
    from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
    from repro_torch.sharding import make_constrain
    from repro_torch.sharding.specs import NamedSharding, map_specs
    from repro_torch.sharding.state import state_specs, unshard_train_state
    from repro_torch.train import train_step as tts
    from repro_torch.utils.tree import Stacked, leaves
    torch.set_num_threads(1)
    cfg = lm_dist_cfg({"arch": "llama3.2-3b"})
    mesh = make_test_mesh((2, 2), ("data", "model"))
    constrain = make_constrain(mesh, fsdp=True)
    step = tts.make_train_step(cfg, constrain=constrain, peak_lr=1e-3,
                               warmup_steps=1, total_steps=10)

    def run(ckpt_dir, fail):
        state = tts.init_train_state(cfg, init_params_sharded(
            cfg, torch.Generator().manual_seed(0), constrain))
        shardings = map_specs(lambda s: NamedSharding(mesh, s),
                              state_specs(state, cfg, constrain.sharding))
        pending = set(fail)

        def inject(i):
            if i in pending:
                pending.discard(i)
                raise RuntimeError(f"injected failure before step {i}")
        loop = FaultTolerantLoop(
            step, state, SyntheticPipeline(cfg, batch=4, seq_len=16,
                                           device="cpu"),
            ckpt_dir, save_every=2, failure_injector=inject,
            shardings=shardings)
        return loop.run(job["steps"]), loop

    plain, _ = run(os.path.join(job["ckpt"], "plain"), ())
    final, loop = run(os.path.join(job["ckpt"], "failed"), job["fail"])
    same = all(torch.equal(a, b) for a, b in zip(leaves(plain),
                                                 leaves(final)))
    full = unshard_train_state(final, cfg, constrain)
    out = {"restarts": loop.restarts, "bitwise": same,
           "steps": [m["step"] for m in loop.metrics_log]}
    if rank == 0:
        def digest(t):
            if isinstance(t, Stacked):
                t = torch.stack(list(t))
            return hashlib.sha256(
                t.contiguous().numpy().tobytes()).hexdigest()
        out["state"] = {}
        _walk(full, (), lambda p, t: out["state"].__setitem__(
            "/".join(p), digest(t)))
        ckpt = os.path.join(job["ckpt"], "failed")
        back = manager.restore(ckpt, manager.latest_step(ckpt), full)
        out["restored"] = {}
        _walk(back, (), lambda p, t: out["restored"].__setitem__(
            "/".join(p), digest(t)))
        out["dirs"] = sorted(os.listdir(ckpt))
    return out


def launchers_on_mesh(rank: int, world: int, job: dict) -> dict:
    """``launch.serve`` and ``launch.train`` without ``--reduced`` (their
    production path) with ``make_production_mesh`` giving a (2, 2) mesh
    and ``get_arch`` the arch's reduced config (a production arch does not
    fit the host): each rank's printed lines."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    torch.set_num_threads(1)
    out = {}
    for mod, argv in ((serve_cli, job["serve"]), (train_cli, job["train"])):
        saved = mod.make_production_mesh, mod.get_arch
        mod.make_production_mesh = lambda multi_pod=False: make_test_mesh(
            (2, 2), ("data", "model"))
        mod.get_arch = lambda name: get_arch(name).reduced()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(list(argv))
        finally:
            mod.make_production_mesh, mod.get_arch = saved
        out[mod.__name__.rsplit(".", 1)[1]] = buf.getvalue().splitlines()
    return out


def moe_decode_cells(rank: int, world: int, job: dict) -> dict:
    """``moe_forward`` at decode sizes (one position; the batch of each
    cell of ``job["moe_cells"]``) on a (2, 2) mesh, impl "psum" and
    "a2a", on this rank's shards of ``job["moe"]``'s weights and the
    cell's rows of ``job["x"]``: the whole output gathered, and the
    local capacity the cell's token count gives."""
    import torch
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.moe import _local_capacity, moe_forward
    from repro_torch.sharding import make_constrain, shard, spec_for_param
    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for cell in job["moe_cells"]:
        constrain = make_constrain(mesh, fsdp=False)
        sh = constrain.sharding
        specs = {k: spec_for_param(["moe", k], v.shape, mesh, fsdp=False,
                                   moe_layout=cell["impl"])
                 for k, v in job["moe"].items()}
        local = {k: shard(torch.as_tensor(v), specs[k], mesh)
                 for k, v in job["moe"].items()}
        x = torch.as_tensor(job["x"][:cell["batch"], :1])
        sh.split = sh.batch_split(cell["batch"], needs_two=True)
        y, _ = moe_forward(local, sh.split_slice(x), n_experts=job["E"],
                           top_k=2, capacity_factor=float(job["E"]),
                           mlp_type="swiglu", impl=cell["impl"],
                           constrain=constrain, specs=specs)
        t_loc = sh.split_slice(x).shape[0]
        out[cell["key"]] = {"y": sh.gather_split(y).numpy(),
                            "capacity": _local_capacity(t_loc, 2, job["E"],
                                                        float(job["E"]))}
    return out


def lm_serve_all(rank: int, world: int, job: dict) -> dict:
    """The serving cases, the MoE decode cells, the fault-tolerant loop
    and the launchers, in one spawn."""
    return {"serve": lm_serve_steps(rank, world, job),
            "moe": moe_decode_cells(rank, world, job),
            "ft": ft_loop_on_mesh(rank, world, job),
            "cli": launchers_on_mesh(rank, world, job)}

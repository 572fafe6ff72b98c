"""The port's sharded LM training step (``repro_torch.sharding``,
``train_step.make_train_step(cfg, constrain=make_constrain(...))``) on
four gloo ranks on the CPU, held against the port's single-device step
(itself held against the JAX package in tests/test_torch_train_step.py),
and its sharded functions held against the JAX package's.

The oracle of every step case is the port's one-device
``make_train_step`` on the same numpy parameters (seed 0) and batches
(``SyntheticPipeline``, seed 0). The JAX package's sharded step fails on
the mesh of its own ``make_test_mesh`` under jax 0.9.0 (ROADMAP C.3:
``jax.make_mesh`` gives Explicit axes, and the embedding gather raises),
but runs on a ``jax.sharding.Mesh`` of the same devices, whose axes are
Auto. There it is a second, direct oracle (``REF_CASES``): the "2x2 tp
nofsdp" cases of llama, mixtral, arctic, jamba and rwkv6, and the "2x2
fsdp" cases of llama and rwkv6 (the reference's "fsdp" layout raises a
DuplicateSpecError on an MoE arch's expert weights: C.3). The four
ranks are spawned once for the file (``tests/torch_dist_ranks.py``)
while one forced-4-device JAX subprocess runs the reference functions
and steps on a thread, as tests/test_torch_sharded.py does.

Tolerances, stated before the first run:

* the steps: loss, ce, aux and grad norm within rtol 1e-5 of the oracle
  (sums over shards run in another order), the lr equal, the parameters
  after two steps within ``chip_smoke._params_close``'s band. An MoE
  arch's capacity factor is E on both sides, so the global path drops no
  token (the sharded paths are dropless at these sizes: T_loc * K <=
  4096). Under the "tp" layout the sharded MoE's aux is the mean of each
  data shard's (GShard's per-group balance loss, the JAX package's
  ``_moe_forward_sharded`` / ``_moe_forward_a2a``), so there the oracle's
  MoE aux is the mean over the same batch groups
  (``torch_dist_ranks.grouped_aux``); its output is the global call's.
  Cases: all ten reduced archs on (2, 2) "tp" with fsdp (C.3's cell);
  llama, mixtral, arctic (Adafactor), jamba and rwkv6 on (2, 2) "tp"
  without fsdp, (2, 2) "fsdp", (1, 4) "tp" (kv heads 2 on 4 model ranks:
  the gathered attention) and (2, 1, 2) with a "pod" axis; llama with
  ``tp_mlp``, with a vocab of 65536 (the fused CE, its denominator the
  global label count) and with each remat mode, mixtral and arctic with
  the a2a MoE;
* against the JAX package's sharded step (``REF_CASES``), each of the two
  steps: loss, ce and aux within rtol 2e-5, grad norm within rtol 2e-4
  (the two links of the chain added: the sharded step against the
  single-device one here, rtol 1e-5; the single-device step against the
  reference in tests/test_torch_train_step.py, rtol 1e-5, grad norm
  1e-4), the lr equal;
* the ranks launch none of the slab kernels;
* ``mlp_forward_tp`` and ``moe_forward`` (impl "psum" with and without
  fsdp, "a2a") against the JAX functions on a (2, 2) mesh with the JAX
  tests' inputs (d = 16, E = 4, ff 32, capacity factor E, x (4, 8, 16)):
  the output within atol 1e-5 / rtol 1e-5, the aux within rtol 1e-5;
* ``psum_compressed`` over 4 ranks against the JAX function: the mean
  within rtol 1e-6 (the four scales are summed in another order), the
  new error state bitwise;
* a sharded state saved on (2, 2) and restored with
  ``reshard_checkpoint`` onto (4, 1), (1, 4) and (1, 1): every leaf
  bitwise ``shard`` of the saved state; the JAX package's
  ``reshard_checkpoint`` reads the same checkpoint bitwise.
"""
import importlib.util
import json
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
import torch_dist_ranks as R

ROOT = Path(__file__).resolve().parent.parent
RANKS, RANKS_TIMEOUT_S, JAX_TIMEOUT_S = 4, 420, 600
RTOL = 1e-5
REF_RTOL, REF_NORM_RTOL = 2e-5, 2e-4
FN_ATOL, FN_RTOL = 1e-5, 1e-5
STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
D, E, FF = 16, 4, 32
MESH = {"2x2 tp": ((2, 2), ("data", "model"), "tp", True),
        "2x2 tp nofsdp": ((2, 2), ("data", "model"), "tp", False),
        "2x2 fsdp": ((2, 2), ("data", "model"), "fsdp", False),
        "1x4 tp": ((1, 4), ("data", "model"), "tp", True),
        "2x1x2 tp": ((2, 1, 2), ("pod", "data", "model"), "tp", True)}
ALL = ["arctic-480b", "deepseek-coder-33b", "gemma3-27b", "internvl2-26b",
       "jamba-1.5-large-398b", "llama3.2-3b", "minitron-8b",
       "mixtral-8x22b", "musicgen-large", "rwkv6-7b"]
FIVE = ["llama3.2-3b", "mixtral-8x22b", "arctic-480b",
        "jamba-1.5-large-398b", "rwkv6-7b"]
VARIANTS = [("llama3.2-3b", {"tp_mlp": True}),
            ("llama3.2-3b", {"vocab_size": 65536}),
            ("llama3.2-3b", {"remat": "full"}),
            ("llama3.2-3b", {"remat": "dots"}),
            ("llama3.2-3b", {"remat": "boundaries"}),
            ("mixtral-8x22b", {"moe_impl": "a2a"}),
            ("arctic-480b", {"moe_impl": "a2a"})]


def _case(arch, mesh, overrides=None):
    shape, axes, layout, fsdp = MESH[mesh]
    over = overrides or {}
    tag = ",".join(f"{k}={v}" for k, v in sorted(over.items()))
    return dict(key=f"{arch}{'[' + tag + ']' if tag else ''} {mesh}",
                arch=arch, overrides=over, mesh=[shape, axes],
                layout=layout, fsdp=fsdp, steps=2, batch=4, seq=16,
                params=True, step_kw=STEP_KW)


CASES = ([_case(a, "2x2 tp") for a in ALL]
         + [_case(a, m) for a in FIVE for m in MESH if m != "2x2 tp"]
         + [_case(a, "2x2 tp", o) for a, o in VARIANTS])
REF_CASES = ([_case(a, "2x2 tp nofsdp") for a in FIVE]
             + [_case(a, "2x2 fsdp") for a in ("llama3.2-3b", "rwkv6-7b")])
CELLS = [dict(key="mlp fsdp", kind="mlp", fsdp=True),
         dict(key="mlp", kind="mlp", fsdp=False),
         dict(key="moe psum fsdp", kind="psum", fsdp=True),
         dict(key="moe psum", kind="psum", fsdp=False),
         dict(key="moe a2a", kind="a2a", fsdp=False)]

JAX_CODE = """
import hashlib, json, os, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint.reshard import reshard_checkpoint
from repro.configs import ARCHS
from repro.launch.mesh import make_test_mesh
from repro.models.layers import mlp_forward_tp
from repro.models.moe import moe_forward
from repro.models.transformer import init_params
from repro.optim.compression import init_error_state, psum_compressed
from repro.sharding.specs import make_constrain
from repro.train.train_step import init_train_state
from repro.utils.compat import shard_map
job = json.loads(JOB)
z = np.load(NPZ)
mesh = make_test_mesh((2, 2), ("data", "model"))
out = {}
for cell in job["cells"]:
    constrain = make_constrain(mesh, fsdp=cell["fsdp"])
    x = jnp.asarray(z["x"])
    with mesh:
        if cell["kind"] == "mlp":
            p = {k: jnp.asarray(z["mlp_" + k]) for k in ("w1", "w2", "w3")}
            y = jax.jit(lambda p, x: mlp_forward_tp(
                p, x, "swiglu", constrain.shard_ctx))(p, x)
            aux = None
        else:
            p = {k: jnp.asarray(z["moe_" + k])
                 for k in ("router", "w1", "w2", "w3")}
            y, aux = jax.jit(lambda p, x: moe_forward(
                p, x, n_experts=job["E"], top_k=2,
                capacity_factor=float(job["E"]), mlp_type="swiglu",
                impl=cell["kind"], constrain=constrain))(p, x)
            aux = float(aux)
    out[cell["key"]] = {"y": np.asarray(y).tolist(), "aux": aux}
m4 = jax.make_mesh((4,), ("data",))
g = {"w": jnp.asarray(z["g"])}
spec = P("data", None)
mean, err = shard_map(lambda g, e: psum_compressed(g, e, ("data",)),
                      mesh=m4, in_specs=(spec, spec), out_specs=(spec, spec),
                      check_vma=False)(g, init_error_state(g))
out["compressed"] = {"mean": np.asarray(mean["w"]).tolist(),
                     "err": np.asarray(err["w"]).tolist()}
import dataclasses, pickle
from jax.sharding import Mesh
from repro.launch.specs import batch_sds_and_shardings, train_state_shardings
from repro.train.train_step import make_train_step
auto = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with open(REF, "rb") as f:
    ref = pickle.load(f)
out["steps"] = {}
for c in ref:
    cfg = dataclasses.replace(ARCHS[c["arch"]].reduced(), **c["overrides"])
    kw = dict(fsdp=c["fsdp"], layout=c["layout"])
    shd = train_state_shardings(cfg, auto, **kw)
    _, bshd = batch_sds_and_shardings(cfg, auto, c["batch"], c["seq"],
                                      layout=c["layout"])
    with auto:
        step = jax.jit(make_train_step(
            cfg, constrain=make_constrain(auto, **kw), **c["step_kw"]),
            in_shardings=(shd, bshd), out_shardings=(shd, None))
        s = jax.device_put(init_train_state(
            cfg, jax.tree.map(jnp.asarray, c["params"])), shd)
        ms = []
        for b in c["batches"]:
            s, m = step(s, {k: jax.device_put(jnp.asarray(v), bshd[k])
                            for k, v in b.items()})
            ms.append({k: float(v) for k, v in m.items()})
    out["steps"][c["key"]] = ms
manifest = os.path.join(job["ckpt"], "step_000000002", "manifest.json")
deadline = time.time() + 300
while not os.path.exists(manifest):
    assert time.time() < deadline, "the port's checkpoint never landed"
    time.sleep(0.2)
cfg = ARCHS["llama3.2-3b"].reduced()
like = init_train_state(cfg, init_params(cfg, jax.random.PRNGKey(0)))
back = reshard_checkpoint(job["ckpt"], 2, like, mesh)
def key(path):
    return "/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                    for k in path)
out["restored"] = {key(p): hashlib.sha256(np.asarray(v).tobytes()).hexdigest()
                   for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
print(json.dumps(out))
"""


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_job(case):
    """A step case for the JAX side: the port's parameters (seed 0) in
    the JAX layout, its batches, and the config's overrides."""
    from repro_torch import convert
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.models.transformer import init_params, param_tree
    cfg = R.lm_dist_cfg(case)
    params = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    pipe = SyntheticPipeline(cfg, batch=case["batch"], seq_len=case["seq"],
                             seed=0, device="cpu")
    batches = [{k: v.numpy() for k, v in pipe.next_batch().items()}
               for _ in range(case["steps"])]
    over = dict(case["overrides"])
    if cfg.n_experts:
        over["capacity_factor"] = cfg.capacity_factor
    return dict(case, overrides=over, batches=batches,
                params=convert.param_tree_to_numpy(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_dist")
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    data = dict(
        x=normal(4, 8, D),
        mlp_w1=normal(D, FF, scale=D ** -0.5),
        mlp_w3=normal(D, FF, scale=D ** -0.5),
        mlp_w2=normal(FF, D, scale=FF ** -0.5),
        moe_router=normal(D, E, scale=D ** -0.5),
        moe_w1=normal(E, D, FF, scale=D ** -0.5),
        moe_w3=normal(E, D, FF, scale=D ** -0.5),
        moe_w2=normal(E, FF, D, scale=FF ** -0.5),
        g=np.arange(32, dtype=np.float32).reshape(4, 8) / 7.0)
    npz = str(tmp / "data.npz")
    np.savez(npz, **data)
    ref = str(tmp / "ref.pkl")
    with open(ref, "wb") as f:
        pickle.dump([_ref_job(c) for c in REF_CASES], f)
    ckpt = str(tmp / "ckpt")
    jjob = dict(cells=CELLS, E=E, ckpt=ckpt)
    code = JAX_CODE.replace("JOB", repr(json.dumps(jjob))).replace(
        "NPZ", repr(npz)).replace("REF", repr(ref))
    job = dict(device="cpu", seed=0, cases=CASES, cells=CELLS, E=E,
               ckpt=ckpt, x=data["x"], g=data["g"],
               mlp={k: data["mlp_" + k] for k in ("w1", "w2", "w3")},
               moe={k: data["moe_" + k] for k in ("router", "w1", "w2",
                                                  "w3")})
    from repro_torch.launch import spawn_ranks
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_forced_devices, code, devices=RANKS,
                               timeout=JAX_TIMEOUT_S)
        port = spawn_ranks(R.lm_dist_all, RANKS, args=(job,),
                           timeout_s=RANKS_TIMEOUT_S, dir=str(tmp))
        ref = jax_side.result()
    return dict(jax=ref, port=port)


@pytest.fixture(scope="module")
def chip_smoke():
    return _load_chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_sharded_step_matches_the_single_device_step(runs, chip_smoke,
                                                     case):
    from repro_torch.utils.tree import leaves
    got = runs["port"][0]["steps"][case["key"]]
    for r in runs["port"][1:]:        # every rank reports the same values
        assert r["steps"][case["key"]]["metrics"] == got["metrics"]
    want, state = R.lm_oracle(case, "cpu", 0)
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL,
                                       err_msg=f"step {i} {k}")
        assert g["lr"] == w["lr"]
    assert want[0]["grad_norm"] > 0
    lr = want[-1]["lr"]
    chip_smoke._params_close([torch.as_tensor(p) for p in got["params"]],
                             leaves(state.params), lr, case["key"])
    ops = got["ops"]
    cfg = R.lm_dist_cfg(case)
    if case["layout"] == "fsdp":
        assert ops.get("reduce_scatter", 0) > 0
    if cfg.moe_impl == "a2a":
        assert ops.get("all_to_all", 0) > 0
    else:
        assert "all_to_all" not in ops


@pytest.mark.parametrize("case", REF_CASES,
                         ids=[c["key"] for c in REF_CASES])
def test_sharded_step_matches_the_reference_sharded_step(runs, case):
    got = runs["port"][0]["steps"][case["key"]]["metrics"]
    want = runs["jax"]["steps"][case["key"]]
    assert len(got) == len(want) == case["steps"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k, rtol in (("loss", REF_RTOL), ("ce", REF_RTOL),
                        ("aux", REF_RTOL), ("grad_norm", REF_NORM_RTOL)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
        assert g["lr"] == w["lr"]


def test_the_ranks_launch_no_slab_kernel(runs):
    for r in runs["port"]:
        assert r["steps"]["launches"] == {"fupdate": 0, "decision": 0,
                                          "gram": 0}


@pytest.mark.parametrize("cell", CELLS, ids=[c["key"] for c in CELLS])
def test_sharded_functions_match_jax(runs, cell):
    got = runs["port"][0]["functions"][cell["key"]]
    want = runs["jax"][cell["key"]]
    np.testing.assert_allclose(got["y"], np.asarray(want["y"], np.float32),
                               atol=FN_ATOL, rtol=FN_RTOL)
    if want["aux"] is not None:
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=FN_RTOL)
    if cell["kind"] == "a2a":
        assert "all_to_all" in got["ops"]
    if cell["fsdp"]:
        assert "all_gather" in got["ops"]


def test_psum_compressed_matches_jax(runs):
    got = runs["port"][0]["functions"]["compressed"]
    want = runs["jax"]["compressed"]
    np.testing.assert_allclose(got["mean"], np.asarray(want["mean"],
                                                       np.float32),
                               rtol=1e-6)
    assert got["err"].tobytes() == np.asarray(want["err"],
                                              np.float32).tobytes()


@pytest.mark.parametrize("mesh", ["4x1", "1x4", "1x1"])
def test_reshard_checkpoint_is_bitwise(runs, mesh):
    ranks = runs["port"] if mesh != "1x1" else runs["port"][:1]
    for r in ranks:
        assert r["functions"]["reshard"][mesh]


def test_the_reference_reads_the_sharded_checkpoint(runs):
    saved = runs["port"][0]["functions"]["saved"]
    assert saved and saved == runs["jax"]["restored"]

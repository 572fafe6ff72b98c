"""The port's sharded LM serving (``train.serve_step.make_prefill`` /
``make_decode`` with ``constrain=make_constrain(...)``, the "tp" and the
"fsdp" layouts) on four gloo ranks on the CPU, held against the port's
single-device prefill + decode (itself held against the JAX package in
tests/test_torch_lm_serve.py) and, where the JAX package's sharded
serving runs, against it directly.

Every rank draws its shards of the parameters (``init_params_sharded``,
seed 0) and of the cache (``init_cache_sharded``), takes the same global
prompt (``torch_dist_ranks.serve_inputs``, seed 1), prefills and decodes
greedily; the oracle is ``torch_dist_ranks.lm_serve_oracle`` on the same
parameters and prompt. The four ranks are spawned once for the file; one
forced-4-device JAX subprocess runs the reference on a thread meanwhile.

Tolerances, stated before the first run:

* the logits of the last position at prefill and at each decode step
  (f32) within rtol 1e-5 and atol 1e-5 x the step's largest |logit| of
  the single-device run (the sums over shards run in another order);
  the greedy tokens equal; every rank reports the same logits and tokens;
* every rank's cache leaf after the last step equals the single-device
  cache's leaf cut by ``cache_spec_for_leaf`` for that rank
  (``collectives.shard``) within the same tolerance (atol scaled by the
  leaf's largest value), and ``unshard_cache`` gives every rank the
  single-device cache within it; ``shard_cache`` of a full cache is that
  cut, and ``init_cache_sharded`` its zeros, on every rank of each mesh,
  both with the same layout (the batch split, the specs, each KV shard's
  slots);
* on the (1, 1) mesh, no ranks needed, the sharded path is the
  single-device run bitwise (all ten reduced archs in f32; llama and
  gemma3 in bf16; under "fsdp" llama and rwkv6 in f32, llama in bf16),
  and the caller's constrain keeps its batch split;
* against the JAX package's sharded ``make_prefill`` / ``make_decode``
  (jitted on a ``jax.sharding.Mesh`` of four forced host devices, whose
  axes are Auto — the JAX package's own ``make_test_mesh`` gives Explicit
  axes, where its sharded path raises: ROADMAP C.3 — with the parameters
  and the cache placed by its ``param_shardings`` / ``decode_specs``):
  the logits within rtol 2e-5 and atol 2e-5 x the largest |logit| (the
  two links of the chain added), the tokens equal; all ten reduced archs
  on (2, 2) "tp" with fsdp, llama at B = 1 and B = 3; the seven archs
  without MoE on (2, 2) "fsdp" (``make_constrain`` and
  ``param_shardings`` with ``layout="fsdp"``, the cache by
  ``decode_specs`` as under "tp"; the JAX package's fsdp MoE spec raises
  ``DuplicateSpecError`` under jax 0.9.0, ROADMAP C.3, so the MoE archs'
  fsdp cases are held against the single-device run alone);
* ``moe_forward`` at decode sizes (one position, B = 4, 3, 1; impl "psum"
  and "a2a") against the JAX function on the same mesh within atol 1e-5
  / rtol 1e-5, and the port's local capacity dropless (T_loc * K, as the
  JAX sharded paths' is while T_loc * K <= 4096);
* decode's collective bytes a step do not grow with the cache length
  (the ledger's "decode" phase at cache lengths 32 and 64, equal);
* the ranks launch none of the slab kernels;
* the dry run's ``cost_cell`` under "fsdp" records a decode and a
  prefill cell of reduced llama on the (2, 2) mesh (rank 0 of a fake
  group of four) with the same cache bytes a rank as under "tp": both
  layouts place the cache by ``cache_spec_for_leaf``;
* ``FaultTolerantLoop`` on (2, 2) with two injected failures restarts
  twice and ends bitwise equal to the uninterrupted sharded run on every
  rank; its checkpoints are one directory of full arrays, which the JAX
  package's ``restore`` and the port's read bitwise the final state;
* ``launch.serve`` and ``launch.train`` run their production path on a
  (2, 2) mesh (``make_production_mesh`` monkeypatched in the ranks, the
  arch reduced to fit the host): the first rank prints the CLIs' two
  lines, the others nothing.

Cases: all ten reduced archs on (2, 2) "tp" with fsdp (prompt 4 x 16, 8
decode steps, a cache of 32); llama, mixtral, jamba and rwkv6 on (2, 2)
without fsdp, (1, 4) (kv heads 2 on 4 model ranks: attention gathered,
positions over 4) and (2, 1, 2) with "pod"; llama at B = 1 (positions
over data + model) and B = 3 (the batch replicates); mixtral's SWA ring
(window 8, split over "model") after a prompt of 16 and of 5 (C.12);
rwkv6 after a prompt of 131 (C.13); llama with a cache of 64. Under
"fsdp" on (2, 2) (the rows over ("data", "model"), each mixer on the
cache's rows over "data"): the ten archs, llama at B = 1 (no split) and
B = 2 (the rows over "data" alone) and with a cache of 64, mixtral after
a prompt of 5, rwkv6 after a prompt of 131; llama, mixtral, jamba and
rwkv6 on (1, 4) and (2, 1, 2) too.
"""
import math
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
import torch_dist_ranks as R

RANKS, RANKS_TIMEOUT_S, JAX_TIMEOUT_S = 4, 600, 600
RTOL, REF_RTOL, FN_TOL = 1e-5, 2e-5, 1e-5
E, D = 4, 16
MESH = {"2x2": ((2, 2), ("data", "model")),
        "1x4": ((1, 4), ("data", "model")),
        "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ALL = ["arctic-480b", "deepseek-coder-33b", "gemma3-27b", "internvl2-26b",
       "jamba-1.5-large-398b", "llama3.2-3b", "minitron-8b",
       "mixtral-8x22b", "musicgen-large", "rwkv6-7b"]
FOUR = ["llama3.2-3b", "mixtral-8x22b", "jamba-1.5-large-398b", "rwkv6-7b"]
FT_STEPS, FT_FAIL = 6, (3, 5)
CLI_SERVE = ["--arch", "llama3.2-3b", "--batch", "4", "--prompt-len", "16",
             "--new-tokens", "8", "--device", "cpu"]


def _case(arch, mesh="2x2", fsdp=True, batch=4, prompt=16, steps=8,
          cache_len=32, layout="tp"):
    shape, axes = MESH[mesh]
    key = (f"{arch} {mesh}{' fsdp' * fsdp}"
           f"{' layout=fsdp' * (layout == 'fsdp')} B={batch} "
           f"prompt={prompt} cache={cache_len}")
    return dict(key=key, arch=arch, mesh=[shape, axes], fsdp=fsdp,
                layout=layout, batch=batch, prompt=prompt, steps=steps,
                cache_len=cache_len, unshard=True)


def _fsdp(arch, **kw):
    """A case under the "fsdp" layout (the fsdp flag is "tp"'s alone)."""
    return _case(arch, fsdp=False, layout="fsdp", **kw)


CASES = ([_case(a) for a in ALL]
         + [_case(a, m, fsdp=f) for a in FOUR
            for m, f in (("2x2", False), ("1x4", True), ("2x1x2", True))]
         + [_case("llama3.2-3b", batch=1), _case("llama3.2-3b", batch=3),
            _case("mixtral-8x22b", prompt=5),
            _case("rwkv6-7b", prompt=131, steps=2, cache_len=136),
            _case("llama3.2-3b", cache_len=64)]
         + [_fsdp(a) for a in ALL]
         + [_fsdp(a, mesh=m) for a in FOUR for m in ("1x4", "2x1x2")]
         + [_fsdp("llama3.2-3b", batch=1), _fsdp("llama3.2-3b", batch=2),
            _fsdp("llama3.2-3b", cache_len=64),
            _fsdp("mixtral-8x22b", prompt=5),
            _fsdp("rwkv6-7b", prompt=131, steps=2, cache_len=136)])
MOE = ["arctic-480b", "jamba-1.5-large-398b", "mixtral-8x22b"]
REF_KEYS = ([_case(a)["key"] for a in ALL]
            + [_case("llama3.2-3b", batch=b)["key"] for b in (1, 3)]
            + [_fsdp(a)["key"] for a in ALL if a not in MOE])
PROBE = (_case("llama3.2-3b")["key"],
         _case("llama3.2-3b", cache_len=64)["key"])
MOE_CELLS = [dict(key=f"{impl} B={b}", impl=impl, batch=b)
             for impl in ("psum", "a2a") for b in (4, 3, 1)]

JAX_CODE = """
import dataclasses, hashlib, json, os, pickle, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.checkpoint import manager
from repro.configs import ARCHS
from repro.launch.specs import decode_specs, param_shardings
from repro.models.moe import moe_forward
from repro.models.transformer import init_cache, init_params
from repro.sharding.specs import make_constrain
from repro.train.serve_step import make_decode, make_prefill
from repro.train.train_step import init_train_state
with open(JOB, "rb") as f:
    job = pickle.load(f)
auto = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {"serve": {}, "moe": {}}
for c in job["ref"]:
    cfg = dataclasses.replace(ARCHS[c["arch"]].reduced(), **c["overrides"])
    constrain = make_constrain(auto, fsdp=c["fsdp"], layout=c["layout"])
    p_shd = param_shardings(cfg, auto, fsdp=c["fsdp"], layout=c["layout"])
    _, c_shd, _, _ = decode_specs(cfg, auto, c["batch"], c["cache_len"])
    with auto:
        params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]),
                                p_shd)
        cache = jax.device_put(init_cache(cfg, c["batch"], c["cache_len"],
                                          dtype=cfg.dtype), c_shd)
        prefill = jax.jit(make_prefill(cfg, constrain=constrain),
                          donate_argnums=(1,))
        decode = jax.jit(make_decode(cfg, constrain=constrain),
                         donate_argnums=(1,))
        logits, cache = prefill(params, cache,
                                {k: jnp.asarray(v)
                                 for k, v in c["inputs"].items()})
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        steps, toks = [np.asarray(logits[:, -1]).tolist()], [tok]
        for _ in range(c["steps"]):
            logits, cache = decode(params, cache, tok)
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            steps.append(np.asarray(logits[:, -1]).tolist())
            toks.append(tok)
    out["serve"][c["key"]] = {
        "logits": steps,
        "tokens": np.asarray(jnp.concatenate(toks, 1)).tolist()}
p = {k: jnp.asarray(v) for k, v in job["moe"].items()}
for cell in job["moe_cells"]:
    x = jnp.asarray(job["x"][:cell["batch"], :1])
    with auto:
        y, _ = jax.jit(lambda p, x: moe_forward(
            p, x, n_experts=job["E"], top_k=2, capacity_factor=float(job["E"]),
            mlp_type="swiglu", impl=cell["impl"],
            constrain=make_constrain(auto, fsdp=False)))(p, x)
    out["moe"][cell["key"]] = np.asarray(y).tolist()
ckpt = job["ft_ckpt"]
manifest = os.path.join(ckpt, "step_%09d" % job["ft_last"], "manifest.json")
deadline = time.time() + 500
while not os.path.exists(manifest):
    assert time.time() < deadline, "the port's checkpoint never landed"
    time.sleep(0.2)
time.sleep(1.0)
cfg = ARCHS["llama3.2-3b"].reduced()
like = init_train_state(cfg, init_params(cfg, jax.random.PRNGKey(0)))
back = manager.restore(ckpt, job["ft_last"], like)
def key(path):
    return "/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                    for k in path)
out["restored"] = {key(p): hashlib.sha256(np.asarray(v).tobytes()).hexdigest()
                   for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
print(json.dumps(out))
"""


def _ref_job(case):
    """A case for the JAX side: the port's parameters (seed 0) in the JAX
    layout, the global inputs, the config's overrides."""
    from repro_torch import convert
    from repro_torch.models.transformer import init_params, param_tree
    cfg = R.lm_dist_cfg(case)
    params = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    inputs = R.serve_inputs(cfg, case["batch"], case["prompt"], 1, "cpu")
    over = {"capacity_factor": cfg.capacity_factor} if cfg.n_experts else {}
    return dict(case, overrides=over,
                inputs={k: v.numpy() for k, v in inputs.items()},
                params=convert.param_tree_to_numpy(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_serve_dist")
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    moe = dict(router=normal(D, E, scale=D ** -0.5),
               w1=normal(E, D, 32, scale=D ** -0.5),
               w3=normal(E, D, 32, scale=D ** -0.5),
               w2=normal(E, 32, D, scale=32 ** -0.5))
    x = normal(4, 8, D)
    ckpt = str(tmp / "ft")
    job = dict(device="cpu", seed=0, cases=CASES, moe=moe, x=x, E=E,
               moe_cells=MOE_CELLS, ckpt=ckpt, steps=FT_STEPS, fail=FT_FAIL,
               serve=CLI_SERVE,
               train=["--arch", "llama3.2-3b", "--steps", "4", "--batch",
                      "4", "--seq-len", "16", "--save-every", "2",
                      "--device", "cpu", "--ckpt-dir", str(tmp / "cli")])
    jjob = str(tmp / "jax.pkl")
    last = (FT_STEPS // 2) * 2 - 1
    with open(jjob, "wb") as f:
        pickle.dump(dict(ref=[_ref_job(c) for c in CASES
                              if c["key"] in REF_KEYS],
                         moe=moe, x=x, E=E, moe_cells=MOE_CELLS,
                         ft_ckpt=ckpt + "/failed", ft_last=last), f)
    code = JAX_CODE.replace("JOB", repr(jjob))
    from repro_torch.launch import spawn_ranks
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_forced_devices, code, devices=RANKS,
                               timeout=JAX_TIMEOUT_S)
        port = spawn_ranks(R.lm_serve_all, RANKS, args=(job,),
                           timeout_s=RANKS_TIMEOUT_S, dir=str(tmp))
        ref = jax_side.result()
    return dict(jax=ref, port=port, ft_last=last)


@pytest.fixture(scope="module")
def oracles():
    return {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _oracle(oracles, case):
    if case["key"] not in oracles:
        oracles[case["key"]] = R.lm_serve_oracle(case, "cpu", 0)
    return oracles[case["key"]]


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_sharded_serving_matches_the_single_device_run(runs, oracles, case):
    from repro_torch.launch.mesh import SolverMesh
    from repro_torch.sharding import shard
    from repro_torch.sharding.state import cache_specs
    ranks = [r["serve"][case["key"]] for r in runs["port"]]
    got = ranks[0]
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["logits"], got["logits"]))
        assert np.array_equal(r["tokens"], got["tokens"])
    want = _oracle(oracles, case)
    assert len(got["logits"]) == len(want["logits"]) == case["steps"] + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, RTOL, f"step {i}")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    # every rank's cache: the single-device cache cut for that rank
    cfg = R.lm_dist_cfg(case)
    shape, axes = case["mesh"]
    n = math.prod(shape)
    specs = [s for st in cache_specs(cfg, case["batch"], case["cache_len"],
                                      SolverMesh(tuple(axes), tuple(shape),
                                                 tuple(range(n)), 0))
             for s in st]
    for rank, r in enumerate(ranks):
        mesh = SolverMesh(tuple(axes), tuple(shape), tuple(range(n)), rank)
        assert len(r["cache"]) == len(want["cache"]) == len(specs)
        for j, (leaf, full, spec) in enumerate(zip(r["cache"], want["cache"],
                                                   specs)):
            cut = shard(torch.as_tensor(full), spec, mesh).numpy()
            assert leaf.shape == cut.shape, (rank, j, spec)
            if np.abs(full).max() > 0:
                _close(leaf, cut, RTOL, f"rank {rank} cache leaf {j}")
                _close(r["full_cache"][j], full, RTOL,
                       f"rank {rank} unsharded cache leaf {j}")
            else:
                assert not np.abs(leaf).any()
                assert not np.abs(r["full_cache"][j]).any()
    ops = got["ops"]
    if any(s.mixer in ("full", "swa") for s in cfg.layer_pattern) \
            and shape[-1] > 1:
        assert ops.get("pmax", 0) > 0     # the flash-decoding combine


@pytest.mark.parametrize("mesh", sorted(MESH))
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_shard_cache_cuts_each_leaf_by_the_cache_rules(mesh, batch):
    """No ranks needed: ``shard`` is local. Every rank's ``shard_cache`` of
    a full cache (jamba: KV and Mamba states) is each leaf cut by
    ``cache_spec_for_leaf``; ``init_cache_sharded`` gives its shapes,
    zero."""
    from repro_torch.launch.mesh import SolverMesh
    from repro_torch.models.transformer import init_cache
    from repro_torch.sharding import (cache_spec_for_leaf, make_constrain,
                                      shard)
    from repro_torch.sharding.specs import P
    from repro_torch.sharding.state import init_cache_sharded, shard_cache
    cfg = R.lm_dist_cfg({"arch": "jamba-1.5-large-398b"})
    shape, axes = MESH[mesh]
    n = math.prod(shape)
    full = init_cache(cfg, batch, 32, device="cpu")
    g = torch.Generator().manual_seed(0)
    full["layers"] = [type(st)(*(torch.randn(t.shape, generator=g)
                                 .to(t.dtype) for t in st))
                      for st in full["layers"]]
    for rank in range(n):
        m = SolverMesh(tuple(axes), tuple(shape), tuple(range(n)), rank)
        c = make_constrain(m)
        got = shard_cache(full, cfg, c)
        zero = init_cache_sharded(cfg, batch, 32, c, device="cpu")
        assert (got["batch"], got["seq_len"]) == (batch, 32)
        for key in ("split", "specs", "slots"):
            assert got[key] == zero[key], key
        for st, gs, zs, slots in zip(full["layers"], got["layers"],
                                     zero["layers"], got["slots"]):
            for f, t, a, z in zip(st._fields, st, gs, zs):
                want = shard(t, cache_spec_for_leaf((f,), t.shape, m), m)
                assert torch.equal(a, want), (rank, f)
                assert z.shape == a.shape and z.dtype == a.dtype
                assert not z.any()
            if slots is not None:       # this rank's slots of the buffer
                assert slots.length == st.k.shape[1]
                mine = st.k.narrow(1, slots.start, slots.n)
                assert torch.equal(gs.k, shard(mine, P(slots.rows or None),
                                               m))


@pytest.mark.parametrize("key", REF_KEYS)
def test_sharded_serving_matches_the_reference_sharded_serving(runs, key):
    got = runs["port"][0]["serve"][key]
    want = runs["jax"]["serve"][key]
    assert len(got["logits"]) == len(want["logits"])
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, REF_RTOL, f"step {i}")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))


def test_decode_collectives_do_not_grow_with_the_cache(runs):
    for r in runs["port"]:
        short, long_ = (r["serve"][k]["bytes"] for k in PROBE)
        assert len(set(short)) == 1 and short == long_
        assert short[0] > 0


@pytest.mark.parametrize("cell", MOE_CELLS, ids=[c["key"] for c in MOE_CELLS])
def test_moe_at_decode_sizes_matches_jax(runs, cell):
    got = runs["port"][0]["moe"][cell["key"]]
    want = np.asarray(runs["jax"]["moe"][cell["key"]], np.float32)
    np.testing.assert_allclose(got["y"], want, atol=FN_TOL, rtol=FN_TOL)
    t_loc = cell["batch"] // 2 if cell["batch"] % 2 == 0 else cell["batch"]
    assert got["capacity"] == t_loc * 2


def test_the_ranks_launch_no_slab_kernel(runs):
    for r in runs["port"]:
        assert r["serve"]["launches"] == {"fupdate": 0, "decision": 0,
                                          "gram": 0}


def test_fault_tolerant_loop_restarts_bitwise_on_the_mesh(runs):
    for r in runs["port"]:
        ft = r["ft"]
        assert ft["restarts"] == len(FT_FAIL)
        assert ft["bitwise"]
    first = runs["port"][0]["ft"]
    # one directory of full arrays, the last save the final state
    assert first["dirs"] == [f"step_{s:09d}" for s in (1, 3, 5)]
    assert first["restored"] == first["state"]
    assert runs["jax"]["restored"] == first["state"]


def test_launchers_run_their_production_path_on_a_mesh(runs):
    import re
    lines = [r["cli"] for r in runs["port"]]
    serve, train = lines[0]["serve"], lines[0]["train"]
    assert len(serve) == 2 and re.fullmatch(
        r"generated \(4, 8\) in \d+ ms \([\d.]+ ms/token\)", serve[0])
    toks = re.fullmatch(r"first sequence: \[([\d, ]+)\]", serve[1])
    assert toks and len(toks.group(1).split(",")) == 8
    assert len(train) == 2 and train[0].startswith("step 0: loss ")
    assert "restarts=0" in train[1] and train[1].startswith("step 3: loss ")
    for other in lines[1:]:
        assert other == {"serve": [], "train": []}


def test_the_serving_cli_prints_the_single_device_tokens(runs):
    """The production path's greedy tokens are the one-device path's."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.train.serve_step import make_decode, make_prefill
    cfg = get_arch("llama3.2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, 4, 24, dtype=cfg.dtype, device="cpu")
    logits, cache = make_prefill(cfg)(params, cache, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    toks = [int(tok[0])]
    for _ in range(7):
        logits, cache = make_decode(cfg)(params, cache, tok)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        toks.append(int(tok[0]))
    assert runs["port"][0]["cli"]["serve"][1] == f"first sequence: {toks}"


ONE_RANK = [(a, "float32") for a in ALL] + [("llama3.2-3b", "bfloat16"),
                                             ("gemma3-27b", "bfloat16")]
ONE_RANK_FSDP = [("llama3.2-3b", "float32"), ("rwkv6-7b", "float32"),
                 ("llama3.2-3b", "bfloat16")]


def _one_rank_bitwise(arch, dtype, layout):
    """Prefill and five decode steps on the (1, 1) mesh under ``layout``
    against the single-device run: every step's logits equal bitwise; the
    caller's constrain keeps its batch split."""
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.sharding import make_constrain
    from repro_torch.sharding.state import init_cache_sharded, shard_params
    from repro_torch.train.serve_step import make_decode, make_prefill
    cfg = R.lm_dist_cfg({"arch": arch,
                         "overrides": {"param_dtype": dtype}})
    constrain = make_constrain(make_test_mesh((1, 1), ("data", "model")),
                               layout=layout)
    split = constrain.sharding.split
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    inputs = R.serve_inputs(cfg, 4, 9, 1, "cpu")
    runs = []
    for con, p, cache in (
            (None, params, init_cache(cfg, 4, 16, device="cpu")),
            (constrain, shard_params(params, cfg, constrain),
             init_cache_sharded(cfg, 4, 16, constrain, device="cpu"))):
        logits, cache = make_prefill(cfg, constrain=con)(p, cache, inputs)
        steps = [logits]
        for _ in range(5):
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            logits, cache = make_decode(cfg, constrain=con)(p, cache, tok)
            steps.append(logits)
        runs.append(steps)
    for i, (a, b) in enumerate(zip(*runs)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"step {i}"
    assert constrain.sharding.split == split


@pytest.mark.parametrize("arch,dtype", ONE_RANK,
                         ids=[f"{a}-{d}" for a, d in ONE_RANK])
def test_one_rank_sharded_serving_is_the_single_device_run_bitwise(arch,
                                                                  dtype):
    """No ranks needed: on the (1, 1) mesh the sharded path's collectives
    are identities and its flash-decoding combine weighs the one rank's
    softmax by exactly 1, so prefill and every decode step give the
    single-device logits bitwise (f32 and bf16). The caller's constrain
    keeps its own batch split."""
    _one_rank_bitwise(arch, dtype, "tp")


@pytest.mark.parametrize("arch,dtype", ONE_RANK_FSDP,
                         ids=[f"{a}-{d}" for a, d in ONE_RANK_FSDP])
def test_one_rank_fsdp_serving_is_the_single_device_run_bitwise(arch,
                                                               dtype):
    """The same under the "fsdp" layout: the rows split over ("data",
    "model") of one rank each, the mixers on the cache's split, every
    weight gathered at use."""
    _one_rank_bitwise(arch, dtype, "fsdp")


DRYRUN_FSDP = """
import json
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.utils.cost_analysis import storage_bytes
cfg = get_arch("llama3.2-3b").reduced()
out = {}
with dryrun.fake_world(4):
    mesh = make_test_mesh((2, 2), ("data", "model"))
    for step in ("decode", "prefill"):
        cell = {"seq_len": 32, "batch": 4, "step": step}
        for layout in ("tp", "fsdp"):
            _, args, _ = dryrun.lower_cell(cfg, cell, mesh, fsdp=False,
                                           layout=layout)
            rec = dryrun.cost_cell(cfg, cell, mesh, fsdp=False,
                                   layout=layout)
            out[f"{step} {layout}"] = {
                "cache_bytes": storage_bytes(args[1]["layers"]),
                "peak": rec["memory"]["peak_bytes_per_device"],
                "flops": rec["op_cost"]["flops_trip_scaled"]}
print(json.dumps(out))
"""


def test_the_dry_run_costs_fsdp_serving_with_the_cache_of_tp():
    """Rank 0 of a fake group of four, the (2, 2) mesh: ``cost_cell``
    under "fsdp" runs a decode and a prefill cell of reduced llama at
    B = 4 (the rows over ("data", "model"), the cache's over "data") and
    its rank's cache takes the bytes it takes under "tp"."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    p = subprocess.run([sys.executable, "-c", DRYRUN_FSDP],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    for step in ("decode", "prefill"):
        tp, fsdp = got[f"{step} tp"], got[f"{step} fsdp"]
        assert fsdp["cache_bytes"] == tp["cache_bytes"] > 0, step
        assert fsdp["peak"] > 0 and fsdp["flops"] > 0, step

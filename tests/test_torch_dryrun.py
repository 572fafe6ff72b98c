"""The port's dry run (``repro_torch.launch.dryrun``) held against the JAX
package's sharding specs, analytic inventory and HLO cost analysis.

* The CLI runs in processes of their own (its fake process group of 256 /
  512 ranks must not reach this one): every arch's ``decode_32k`` on the
  (16, 16) mesh, llama3.2-3b's ``train_4k`` and rwkv6-7b's
  ``prefill_32k`` on it and llama3.2-3b's ``decode_32k`` on the (2, 16,
  16) mesh; jamba's ``train_4k`` at one microbatch beside them, its op
  count times its microbatches under ``MAX_OPS``. Each record is ``ok``, its sections complete
  and consistent (peak = argument + output + temp - alias; the roofline's
  terms from the counted FLOPs, the analytic bytes and the collective
  bytes), and the fake group is gone when ``fake_world`` exits.
* ``argument_bytes_per_device`` is exactly the sum of the JAX package's
  ``NamedSharding(AbstractMesh).shard_shape`` bytes over the same cell's
  ``input_specs``, less 4 bytes in a serving cell: the cache's int32
  position, which the port keeps as a host int.
* ``should_skip`` agrees with the reference's rule on all 40 arch x shape
  cells (``repro.configs.long_context_capable``; the reference's
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import, so it is not
  imported here); the records' analytic numbers are the JAX package's.
* On a (1, 1) mesh (no process group), every reduced arch's train
  (one microbatch), prefill and decode FLOPs counted in the op stream lie
  within 5% of the JAX package's ``hlo_analysis`` of its compiled sharded
  step on a one-device Auto-axes mesh (prefill and decode equal to the
  FLOP; train too but for jamba's and rwkv6's recomputed scans, within
  1.1%: the scan operators' backward counts its chunk's recompute, as
  the plain chunked scan's operations do).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import Mesh as JMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import long_context_capable as j_long_context_capable
from repro.launch import specs as jspecs
from repro.sharding.specs import make_constrain as j_make_constrain
from repro.train.serve_step import make_decode as j_make_decode
from repro.train.serve_step import make_prefill as j_make_prefill
from repro.train.train_step import make_train_step as j_make_train_step
from repro.utils import hlo_analysis
from repro.utils import roofline as jroofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCH_IDS = sorted(ARCHS)
RUNS = {  # (--arch, --shape, --mesh) of each CLI process
    "decode": ("all", "decode_32k", "single"),
    "train": ("llama3.2-3b", "train_4k", "single"),
    "multi": ("llama3.2-3b", "decode_32k", "multi"),
    "scan": ("rwkv6-7b", "prefill_32k", "single"),
}
CELLS = ([(a, "decode_32k", "single") for a in ARCH_IDS]
         + [("llama3.2-3b", "train_4k", "single"),
            ("llama3.2-3b", "decode_32k", "multi"),
            ("rwkv6-7b", "prefill_32k", "single")])
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
TIMEOUT_S = 600

# jamba's train_4k cell at one microbatch, as rank 0 of the (16, 16) mesh:
# its op count and the production microbatch count.
MICROBATCH_OPS = """
import json
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
cfg = get_arch("jamba-1.5-large-398b")
with dryrun.fake_world(256):
    mesh = make_production_mesh()
    mb = dryrun.microbatches_for(cfg, SHAPES["train_4k"]["batch"], mesh)
    rec = dryrun.cost_cell(cfg, "train_4k", mesh, fsdp=True, microbatches=1)
print(json.dumps({"ops": rec["ops"], "microbatches": mb}))
"""

LEAK_CHECK = """
import json
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, _world
with dryrun.fake_world(256):
    inside = (_world(), make_production_mesh().sizes)
print(json.dumps({"inside": list(inside[0]), "sizes": list(inside[1]),
                  "after": dist.is_initialized()}))
"""


def _cli(out_dir: Path, arch: str, shape: str, mesh: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out_dir)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
        cwd=str(ROOT))


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The three CLI processes, run at once: ({cell: record}, {run:
    stdout}, the leak check's output)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with ThreadPoolExecutor(len(RUNS) + 2) as pool:
        futs = {k: pool.submit(_cli, out, *v) for k, v in RUNS.items()}
        leak, mb = (pool.submit(
            subprocess.run, [sys.executable, "-c", textwrap.dedent(code)],
            capture_output=True, text=True, env=env, timeout=TIMEOUT_S)
            for code in (LEAK_CHECK, MICROBATCH_OPS))
        procs = {k: f.result() for k, f in futs.items()}
        leak, mb = leak.result(), mb.result()
    for k, p in procs.items():
        assert p.returncode == 0, (k, p.stderr[-3000:])
    for p in (leak, mb):
        assert p.returncode == 0, p.stderr[-3000:]
    recs = {}
    for arch, shape, mesh in CELLS:
        with open(out / f"{arch}__{shape}__{mesh}.json") as f:
            recs[(arch, shape, mesh)] = json.load(f)
    recs["microbatch"] = json.loads(mb.stdout.strip().splitlines()[-1])
    return recs, {k: p.stdout for k, p in procs.items()}, leak.stdout


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_cell_is_ok_and_complete(sweep, cell):
    recs, stdout, _ = sweep
    rec = recs[cell]
    arch, shape, mesh = cell
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["arch"], rec["shape"], rec["layout"]) == (arch, shape, "tp")
    assert rec["mesh"] == ("2x16x16" if mesh == "multi" else "16x16")
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes_per_device"] + mem["output_bytes_per_device"]
        + mem["temp_bytes_per_device"] - mem["alias_bytes_per_device"])
    assert 0 < mem["argument_bytes_per_device"] < mem["peak_bytes_per_device"]
    assert mem["fits_80gb_hbm"] == (mem["peak_bytes_per_device"] < 80e9)
    chips = math.prod(MESHES[mesh][0])
    op, rf, an = rec["op_cost"], rec["roofline"], rec["analytic"]
    assert op["flops_trip_scaled"] > 0 and op["hbm_bytes_upper_bound"] > 0
    assert op["collective_bytes"] == pytest.approx(
        sum(op["collectives"].values()), rel=1e-12)
    assert set(op["collectives"]) <= {"all-gather", "all-reduce",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute", "broadcast"}
    assert rf["chips"] == chips and rf["precision"] == "bf16"
    assert rf["compute_s"] == pytest.approx(
        op["flops_trip_scaled"] / (chips * 989e12), rel=1e-12)
    assert rf["memory_s"] == pytest.approx(
        an["model_hbm_bytes"] / (chips * 3.35e12), rel=1e-12)
    assert rf["collective_s"] == pytest.approx(
        op["collective_bytes"] / (chips * 450e9), rel=1e-12)
    bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    assert rf["mfu_fraction"] == pytest.approx(
        an["model_flops"] / (chips * 989e12 * bound), rel=1e-12)
    assert an["useful_flops_ratio"] == pytest.approx(
        an["model_flops"] / op["flops_trip_scaled"], rel=1e-12)
    # the analytic inventory is the JAX package's
    jcfg = JARCHS[arch]
    assert an["model_flops"] == pytest.approx(
        jroofline.model_flops(jcfg, shape), rel=1e-12)
    assert an["model_hbm_bytes"] == pytest.approx(
        jroofline.model_hbm_bytes(jcfg, shape, chips, fsdp=rec["fsdp"]),
        rel=1e-12)
    # one line a cell, as the reference's main prints
    run = next(k for k, v in RUNS.items()
               if v[1:] == (shape, mesh) and v[0] in (arch, "all"))
    tag = f"{arch}__{shape}__{mesh}"
    assert f"[dryrun] {tag}: ok lower=" in stdout[run]


def test_jamba_train_4k_is_inside_the_op_budget(sweep):
    """jamba's train_4k cell takes minutes on a CPU, so its CLI run is left to
    the sweep; each microbatch dispatches the same operations, so the
    cell's count is at most its microbatch count times the count of the
    cell at one microbatch (the optimizer once), which must lie under
    ``MAX_OPS``: one scan operator a Mamba layer and a pass, where the
    scan as a Python loop over 4096 positions passed the budget."""
    got = sweep[0]["microbatch"]
    assert got["microbatches"] > 1
    assert got["ops"] * got["microbatches"] < dryrun.MAX_OPS


def test_the_fake_group_does_not_outlive_the_dry_run(sweep):
    got = json.loads(sweep[2].strip().splitlines()[-1])
    assert got == {"inside": [0, 256], "sizes": [16, 16], "after": False}


def _jax_shard_bytes(arch: str, shape: str, mesh: str, fsdp: bool) -> int:
    sizes, axes = MESHES[mesh]
    _, args, shds = jspecs.input_specs(JARCHS[arch], shape,
                                       JAbstractMesh(sizes, axes),
                                       fsdp=fsdp, layout="tp")
    leaves = jax.tree.leaves(args)
    shardings = jax.tree.leaves(
        shds, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shardings)
    return sum(math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, shardings))


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_argument_bytes_are_the_jax_shard_bytes(sweep, cell):
    rec = sweep[0][cell]
    arch, shape, mesh = cell
    want = _jax_shard_bytes(arch, shape, mesh, rec["fsdp"])
    if SHAPES[shape]["step"] != "train":
        want -= 4          # the cache's int32 position: a host int here
    assert rec["memory"]["argument_bytes_per_device"] == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_should_skip_follows_the_reference_rule(arch, shape):
    want = shape == "long_500k" and not j_long_context_capable(JARCHS[arch])
    assert bool(dryrun.should_skip(arch, shape)) == want


# -- counted FLOPs against the JAX package's hlo_analysis, (1, 1) mesh ----

B, S = 2, 32


def _jax_step(jcfg, step: str, jmesh):
    """The JAX package's sharded step of a cell of B x S on ``jmesh`` and
    its inputs (shapes only)."""
    con = j_make_constrain(jmesh, fsdp=False)
    batch, _ = jspecs.batch_sds_and_shardings(jcfg, jmesh, B, S)
    if step == "train":
        return (j_make_train_step(jcfg, constrain=con, microbatches=1),
                (jspecs.train_state_sds(jcfg), batch))
    params = jspecs.params_sds(jcfg)
    cache = jspecs.cache_sds(jcfg, B, S)
    if step == "decode":
        return (j_make_decode(jcfg, constrain=con),
                (params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32)))
    batch.pop("labels")
    return (j_make_prefill(jcfg, constrain=con, q_chunk=1024),
            (params, cache, batch))


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counted_flops_match_hlo_analysis(arch, step):
    jcfg, cfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    fn, args = _jax_step(jcfg, step, jmesh)
    with jmesh:
        text = jax.jit(fn).lower(*args).compile().as_text()
    want = hlo_analysis.analyze(text).flops
    rec = dryrun.cost_cell(cfg, {"seq_len": S, "batch": B, "step": step},
                           make_test_mesh((1, 1), ("data", "model")),
                           fsdp=False, microbatches=1)
    got = rec["op_cost"]["flops_trip_scaled"]
    print(f"{arch} {step}: counted {got:.6e} FLOPs, hlo_analysis "
          f"{want:.6e}, ratio {got / want:.6f}")
    assert got == pytest.approx(want, rel=0.05)
    assert "analytic" not in rec        # a cell of its own: no inventory

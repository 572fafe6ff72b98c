"""``repro_torch.utils.cost_analysis`` — the op-level counterpart of the JAX
package's ``repro.utils.hlo_analysis`` — on known functions.

* The reference's own test function, ten steps of relu(x @ w) at (64,
  128) x (128, 128): the op stream counts exactly 10 * 2 * 64 * 128 * 128
  FLOPs, on the CPU and on ``meta``; the JAX analyzer on the compiled
  scan lies within its own 5% of the same number.
* One matmul's bytes are exact: its two operands read, its result
  written; views move nothing; a backward counts its two matmuls.
* Storages: what a call allocates and frees is followed (``peak``, the
  most held at once); an in-place result allocates nothing.
* Collectives: a known all-gather and all-reduce through ``MeshComm``
  with a ``CollectiveLedger`` come out under the reference's kind names
  with the ledger's bytes (the gathered output for an all-gather, the
  operand for an all-reduce), with no process group and, in a process
  of its own, over a fake group of four ranks on a (2, 2) mesh.
* ``bincount`` on meta takes ``minlength`` (the MoE router's counts);
  ``max_ops`` stops a call that runs past it.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.utils import hlo_analysis
from repro_torch.core.engine.stats import CollectiveLedger, MeshComm
from repro_torch.utils import cost_analysis as ca

ROOT = Path(__file__).resolve().parents[1]
EXPECTED = 10 * 2 * 64 * 128 * 128


def _scan(x, w):
    for _ in range(10):
        x = torch.relu(x @ w)
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ten_step_scan_counts_its_flops_exactly(device):
    x = torch.ones(64, 128, device=device)
    w = torch.ones(128, 128, device=device)
    out, cost = ca.analyze(_scan, x, w)
    assert cost.flops == EXPECTED
    assert tuple(out.shape) == (64, 128)
    assert cost.coll == {} and cost.collective_bytes == 0
    # ten matmuls and ten relus, each reading its operands and writing
    # its result, all f32
    mm = (64 * 128 + 128 * 128 + 64 * 128) * 4
    relu = 2 * 64 * 128 * 4
    assert cost.bytes == 10 * (mm + relu)


def test_the_reference_analyzer_on_the_same_function_is_within_5pct():
    def f(x, w):
        def body(c, _):
            return jnp.maximum(c @ w, 0.0), None
        out, _ = jax.lax.scan(body, x, None, length=10)
        return out

    x = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    w = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    text = jax.jit(f).lower(x, w).compile().as_text()
    got = hlo_analysis.analyze(text).flops
    port = ca.analyze(_scan, torch.ones(64, 128, device="meta"),
                      torch.ones(128, 128, device="meta"))[1].flops
    assert got == pytest.approx(EXPECTED, rel=0.05)
    assert port == pytest.approx(got, rel=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_matmul_bytes_are_exact(dtype):
    a = torch.ones(64, 128, dtype=dtype, device="meta")
    b = torch.ones(128, 32, dtype=dtype, device="meta")
    _, cost = ca.analyze(torch.mm, a, b)
    size = torch.tensor([], dtype=dtype).element_size()
    assert cost.bytes == (64 * 128 + 128 * 32 + 64 * 32) * size
    assert cost.flops == 2 * 64 * 128 * 32
    # views and metadata move nothing
    _, cost = ca.analyze(
        lambda t: t.t()[:, :5].unsqueeze(0).expand(3, -1, -1), b)
    assert cost.bytes == 0 and cost.flops == 0
    # a reshape that cannot be a view copies: read and written once
    _, cost = ca.analyze(lambda t: t.t().reshape(-1), b)
    assert cost.bytes == 2 * 128 * 32 * size


def test_a_backward_counts_both_of_its_matmuls():
    x = torch.ones(8, 16, device="meta", requires_grad=True)
    w = torch.ones(16, 4, device="meta", requires_grad=True)

    def step():
        return torch.autograd.grad((x @ w).sum(), [x, w])
    _, cost = ca.analyze(step)
    assert cost.flops == 3 * 2 * 8 * 16 * 4


def test_storages_freed_and_peak():
    n = 1024 * 4

    def f(x):
        a = x * 2          # a new storage
        b = a + 1          # another: both alive
        del a              # freed
        b.add_(1)          # in place: nothing new
        c = b * 3          # takes the place a held
        return c
    x = torch.ones(1024, device="meta")
    out, cost, info = ca.analyze_with_memory(f, x)
    assert info.peak == 2 * n
    assert ca.storage_bytes([x, out, x.view(2, 512)]) == 2 * n
    seen: set = set()
    assert ca.storage_bytes(x, seen) == n and ca.storage_bytes(x, seen) == 0


def test_collectives_without_a_process_group():
    ledger = CollectiveLedger()
    ledger.set_phase("step")
    gather = MeshComm(("data",), sizes=(2,), ledger=ledger)
    red = MeshComm(("model",), sizes=(2,), ledger=ledger)

    def f(x):
        return red.psum(gather.all_gather(x))
    out, cost = ca.analyze(f, torch.ones(8, 3), ledger=ledger)
    # no group: identities that still record their payloads
    assert cost.coll == {"all-gather": 8 * 3 * 4 * 2, "all-reduce": 8 * 3 * 4}
    assert cost.collective_bytes == 8 * 3 * 4 * 3
    # only the call's own records
    _, again = ca.analyze(lambda x: x + 1, torch.ones(2), ledger=ledger)
    assert again.coll == {}


FAKE_GROUP = """
import json
import torch
import torch.distributed as dist
from repro_torch.core.engine.stats import CollectiveLedger
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding.specs import make_constrain
from repro_torch.utils import cost_analysis as ca
with dryrun.fake_world(4):
    ledger = CollectiveLedger()
    ledger.set_phase("step")
    mesh = make_test_mesh((2, 2), ("data", "model"))
    sh = make_constrain(mesh, ledger=ledger).sharding
    x = torch.ones(8, 3, dtype=torch.bfloat16, device="meta")

    def f(x):
        g = sh.comm(("model",)).all_gather(x, dim=1)
        return sh.psum(g.float(), ("data", "model"))
    out, cost = ca.analyze(f, x, ledger=ledger)
    got = {"coll": cost.coll, "shape": list(out.shape),
           "dtype": str(out.dtype), "flops": cost.flops}
print(json.dumps(got))
"""


def test_collectives_over_a_fake_group_of_four_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(FAKE_GROUP)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    # all_gather over "model" (2 ranks): the gathered (8, 6) bf16 output;
    # psum over both axes: the (8, 6) f32 operand
    assert got["coll"] == {"all-gather": 8 * 6 * 2, "all-reduce": 8 * 6 * 4}
    assert got["shape"] == [8, 6] and got["dtype"] == "torch.float32"


def test_bincount_on_meta_takes_minlength():
    ids = torch.zeros(12, dtype=torch.int64, device="meta")
    out, _ = ca.analyze(lambda t: torch.bincount(t, minlength=8), ids)
    assert tuple(out.shape) == (8,) and out.dtype == torch.int64
    # on real tensors the operation itself runs
    cpu = torch.tensor([0, 2, 2])
    out, _ = ca.analyze(lambda t: torch.bincount(t, minlength=4), cpu)
    assert out.tolist() == [1, 0, 2, 0]


def test_max_ops_stops_a_long_call():
    x = torch.ones(4, 4, device="meta")
    with pytest.raises(ca.OpBudgetExceeded):
        ca.analyze_with_memory(_scan, x, x, max_ops=5)
    _, _, info = ca.analyze_with_memory(_scan, x, x, max_ops=20)
    assert info.ops == 20


def test_cost_add_scales_every_term():
    c = ca.Cost(flops=1.0, bytes=2.0, coll={"all-reduce": 3.0})
    c.add(ca.Cost(flops=1.0, bytes=1.0, coll={"all-reduce": 1.0,
                                              "all-gather": 2.0}), scale=10)
    assert (c.flops, c.bytes) == (11.0, 12.0)
    assert c.coll == {"all-reduce": 13.0, "all-gather": 20.0}
    assert c.collective_bytes == 33.0

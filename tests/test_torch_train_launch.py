"""The port's training state through the checkpoint manager and the
fault-tolerant loop, the ``repro_torch.launch.train`` CLI and
``examples/torch_train_lm.py``, on the CPU at reduced sizes.

* A ``TrainState`` (AdamW and Adafactor; f32 and bf16 parameters)
  round-trips through ``checkpoint.manager`` bitwise, ``Stacked`` leaves
  and the step included.
* ``FaultTolerantLoop`` over the port's train step on reduced llama, with
  failures injected at steps 6 and 11, restarts twice and each replayed
  step's loss is within 1e-5 of its first run
  (``tests/test_fault_tolerance.py``'s rule); too many failures raise;
  the data cursor resumes from the checkpoint.
* The CLI prints the JAX package's two lines; its first loss equals the
  reference's ``make_train_step`` on the same parameters (the CLI's,
  carried across) and the same batch within 1e-4 (it prints four
  decimals). The JAX package's own ``repro.launch.train --reduced`` fails
  under jax 0.9.0 (ROADMAP C.17), so its ``make_train_step`` is called
  directly. ``--layout fsdp --reduced`` gives the "tp" layout's first
  loss on the (1, 1) mesh; without ``--reduced`` the production mesh
  ((16, 16), or (2, 16, 16) with ``--multi-pod``) raises for want of
  ranks, and with all its ranks the launcher no longer refuses: it draws
  only this rank's shards (``init_params_sharded``, stopped there; the
  production path itself runs on a (2, 2) mesh in
  tests/test_torch_lm_serve_dist.py).
* The example trains a few steps on the CPU and its loss falls.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data.synthetic import SyntheticPipeline as JPipeline
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import SyntheticPipeline
from repro_torch.models.transformer import init_params
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.tree import Stacked, leaves

ROOT = Path(__file__).resolve().parent.parent
LLAMA = "llama3.2-3b"


def _state(arch, steps=2, **kw):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    state = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    step = make_train_step(cfg, peak_lr=1e-3, warmup_steps=1,
                           total_steps=10)
    pipe = SyntheticPipeline(cfg, batch=2, seq_len=8, device="cpu")
    for _ in range(steps):
        state, _ = step(state, pipe.next_batch())
    return cfg, state


@pytest.mark.parametrize("arch,dtype", [
    (LLAMA, "float32"), (LLAMA, "bfloat16"), ("arctic-480b", "float32"),
    ("jamba-1.5-large-398b", "bfloat16")])
def test_train_state_round_trips_through_the_manager(tmp_path, arch, dtype):
    cfg, state = _state(arch, param_dtype=dtype)
    assert isinstance(state.params["segments"]["l0"]["norm1"], Stacked)
    manager.save(str(tmp_path), 2, state)
    like = _state(arch, steps=0, param_dtype=dtype)[1]
    back = manager.restore(str(tmp_path), 2, like)
    assert type(back) is type(state)
    assert type(back.opt_state) is type(state.opt_state)
    assert isinstance(back.params["segments"]["l0"]["norm1"], Stacked)
    a, b = leaves(state), leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)
    assert int(back.step) == 2
    if dtype == "bfloat16":
        assert back.params["embed"].dtype == torch.bfloat16



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are small, and torch's threads
    spin at each op's barrier when pytest-xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- the fault-tolerant loop --------------------------------------------------

def _loop(tmp_path, injector=None, save_every=4):
    cfg = ARCHS[LLAMA].reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    step = make_train_step(cfg, peak_lr=1e-3, warmup_steps=2,
                           total_steps=100)
    pipe = SyntheticPipeline(cfg, batch=2, seq_len=16, seed=0, device="cpu")
    return FaultTolerantLoop(step, init_train_state(cfg, params), pipe,
                             str(tmp_path), save_every=save_every,
                             failure_injector=injector)


def test_restart_resumes_and_replays_deterministically(tmp_path):
    fails = {6, 11}

    def injector(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError("injected")

    loop = _loop(tmp_path, injector)
    loop.run(14)
    assert loop.restarts == 2
    by_step, replayed = {}, 0
    for m in loop.metrics_log:
        if m["step"] in by_step:
            replayed += 1
            assert abs(by_step[m["step"]] - m["loss"]) < 1e-5
        by_step[m["step"]] = m["loss"]
    assert set(by_step) == set(range(14)) and replayed > 0
    assert int(loop.state.step) == 14


def test_too_many_failures_raises(tmp_path):
    def injector(s):
        raise RuntimeError("always failing")

    loop = _loop(tmp_path, injector)
    loop.max_restarts = 3
    with pytest.raises(RuntimeError):
        loop.run(5)
    assert loop.restarts == 4


def test_data_cursor_resumes(tmp_path):
    loop = _loop(tmp_path, save_every=2)
    loop.run(4)
    assert loop.pipeline.cursor.step == 4
    again = _loop(tmp_path, save_every=2)
    again.run(6)
    # resumed from the step-3 checkpoint: only steps 4 and 5 ran
    assert [m["step"] for m in again.metrics_log] == [4, 5]
    assert again.pipeline.cursor.step == 6
    assert int(again.state.step) == 6


# -- the CLI (``tests/test_torch_lm_imports.py`` runs it as a process) -------

def test_cli_prints_the_reference_lines_and_its_first_loss(tmp_path,
                                                          capsys):
    from repro_torch.launch import train
    train.main(["--arch", LLAMA, "--reduced", "--steps", "6", "--device",
                "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2, lines
    first = re.fullmatch(r"step 0: loss (\d+\.\d{4})", lines[0])
    last = re.fullmatch(r"step 5: loss (\d+\.\d{4}) \(\d+ ms/step, "
                        r"restarts=0\)", lines[1])
    assert first and last, lines
    # the reference's make_train_step on the CLI's parameters and batch
    cfg, jcfg = ARCHS[LLAMA].reduced(), JARCHS[LLAMA].reduced()
    params = convert.lm_params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    step = jax.jit(jts.make_train_step(jcfg, peak_lr=3e-4, warmup_steps=1,
                                       total_steps=6))
    batch = JPipeline(jcfg, batch=8, seq_len=256, seed=0).next_batch()
    _, m = step(jts.init_train_state(jcfg, params), batch)
    assert abs(float(first.group(1)) - float(m["loss"])) < 1e-4
    assert float(last.group(1)) < float(first.group(1))


@pytest.mark.parametrize("flag", [[], ["--multi-pod"]])
def test_cli_refuses_the_production_mesh(flag):
    """Without ``--reduced`` the launcher builds the production mesh over
    the process group, (16, 16) or (2, 16, 16) with ``--multi-pod``: one
    process has too few ranks, and it raises as the JAX package's
    ``make_production_mesh`` does."""
    from repro_torch.launch import train
    n = 512 if flag else 256
    with pytest.raises(RuntimeError, match=f"needs {n} ranks, found 1"):
        train.main(["--arch", LLAMA, "--device", "cpu", *flag])


@pytest.mark.parametrize("flag", [[], ["--multi-pod"]])
def test_cli_refuses_a_full_production_mesh(monkeypatch, flag):
    """With every rank of the production mesh there, the launcher no
    longer refuses (it did until the per-rank draw was ported): it draws
    only this rank's shards of the parameters, on that mesh (stopped
    there: the whole model would not train on the host)."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import SolverMesh
    shape = (2, 16, 16) if flag else (16, 16)
    axes = ("pod", "data", "model") if flag else ("data", "model")
    mesh = SolverMesh(axes, shape, tuple(range(int(np.prod(shape)))), 0)
    monkeypatch.setattr(train, "make_production_mesh",
                        lambda *, multi_pod: mesh)
    calls = []

    class Drawn(Exception):
        pass

    def draw(cfg, generator, constrain):
        calls.append((cfg.name, constrain.sharding.mesh))
        raise Drawn

    monkeypatch.setattr(train, "init_params_sharded", draw)
    with pytest.raises(Drawn):
        train.main(["--arch", LLAMA, "--device", "cpu", *flag])
    assert calls == [(LLAMA, mesh)]


def test_cli_fsdp_layout_matches_the_tp_layout(tmp_path, capsys):
    """``--layout fsdp --reduced`` trains on the (1, 1) mesh; its first
    loss is the "tp" layout's."""
    from repro_torch.launch import train
    first = {}
    for layout in ("tp", "fsdp"):
        train.main(["--arch", LLAMA, "--reduced", "--steps", "2",
                    "--batch", "2", "--seq-len", "16", "--device", "cpu",
                    "--layout", layout, "--ckpt-dir",
                    str(tmp_path / layout)])
        lines = capsys.readouterr().out.strip().splitlines()
        first[layout] = re.fullmatch(r"step 0: loss (\d+\.\d{4})",
                                     lines[0]).group(1)
    assert first["fsdp"] == first["tp"]


# -- the example -----------------------------------------------------------

def test_example_trains_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    loop = example.main(["--steps", "10", "--batch", "2", "--seq-len",
                         "16", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path / "ck")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("model: 8.1M params, 4L x 256d")
    assert re.fullmatch(r"step 0: loss \d+\.\d{3}", lines[1])
    assert re.match(r"step 9: loss \d+\.\d{3} \(\d+ ms/step\)", lines[2])
    assert lines[3].endswith("restarts=0")
    losses = [m["loss"] for m in loop.metrics_log]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]

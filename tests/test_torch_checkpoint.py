"""The port's checkpoint manager held against the JAX package's.

* The on-disk format crosses packages: the same tree gives the same
  manifest keys and a byte-equal ``arrays.npz`` (so the same sha256) —
  f32/int/bool leaves, an ``SMOResult`` carried across with ``convert``,
  bf16 leaves — with the zip entries' timestamps pinned (``np.savez``
  stamps the time of writing into each entry); a checkpoint written by
  one package restores bitwise in the other.
* bf16 round-trips bitwise in the port, and the port reads the bits of a
  bf16 leaf the JAX package wrote (which the JAX package itself cannot
  restore: ROADMAP C.11).
* The reference's own checks, on the port: corruption detected, ``extra``
  round-trips, ``latest_step`` and GC; restore keeps each leaf's dtype
  and device and takes a placement tree; a caller's in-place update after
  ``AsyncCheckpointer.save`` returns does not reach the file; an SMO warm
  restart from restored gamma converges.
"""
import json
import os
import threading
import time
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
from repro.checkpoint import manager as jm
from repro_torch import convert
from repro_torch.checkpoint import manager as tm
from repro_torch.checkpoint.manager import AsyncCheckpointer
from repro_torch.core import SlabSpec, rbf, solve_blocked
from repro_torch.data import make_toy

J_SPEC = jc.SlabSpec(nu1=0.5, nu2=0.1, eps=0.5, kernel=jc.rbf(gamma=0.5))


@pytest.fixture
def pinned_zip_clock(monkeypatch):
    """Every zip entry stamped with one time, in both packages' writes."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))


@pytest.fixture(scope="module")
def results():
    """A JAX fit at m = 64 and the same result carried into the port. The
    JAX result's spec is the host-float spec it was fitted with (its fit
    returns the kernel's parameters as f32 arrays, the port's as host
    floats: two different trees)."""
    X = make_toy(0, 64)[0]
    jres = repro.fit(jnp.asarray(X), J_SPEC, strategy="blocked", tol=1e-3)
    jres = jres._replace(model=jres.model._replace(spec=J_SPEC))
    k = J_SPEC.kernel
    spec = convert.spec_from_params(nu1=J_SPEC.nu1, nu2=J_SPEC.nu2,
                                    eps=J_SPEC.eps, kernel=k.name,
                                    gamma=k.gamma, coef0=k.coef0,
                                    degree=k.degree)
    model = convert.model_from_params(
        gamma=np.asarray(jres.model.gamma), rho1=float(jres.model.rho1),
        rho2=float(jres.model.rho2), X=np.asarray(jres.model.X), spec=spec)
    tres = convert.result_from_params(
        model=model, iters=int(jres.iters), n_viol=int(jres.n_viol),
        max_viol=float(jres.max_viol), gap=float(jres.gap),
        converged=bool(jres.converged), f=np.asarray(jres.f))
    return jres, tres


def _trees(kind, results):
    """(JAX tree, port tree) holding the same values."""
    if kind == "smo-result":
        jres, tres = results
        return ({"res": jres, "step": jnp.int32(3)},
                {"res": tres, "step": torch.tensor(3, dtype=torch.int32)})
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    if kind == "bf16":
        bits = rng.integers(0, 2 ** 15, (7,), dtype=np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
        return ({"w": jnp.asarray(t.float().numpy(), jnp.bfloat16),
                 "x": jnp.asarray(a)},
                {"w": t, "x": torch.from_numpy(a)})
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)
    mask = np.array([True, False, True])
    return ({"z": jnp.asarray(a), "a": [jnp.asarray(ints), (jnp.asarray(mask),
                                                           jnp.float32(2.5))],
             "m": {"b": jnp.asarray(a[0]), "a": jnp.asarray(ints[0])}},
            {"z": torch.from_numpy(a),
             "a": [torch.from_numpy(ints), (torch.from_numpy(mask),
                                            torch.tensor(2.5))],
             "m": {"b": torch.from_numpy(a[0]),
                   "a": torch.from_numpy(ints[0])}})


def _files(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        return manifest, f.read()


@pytest.mark.parametrize("kind", ["f32-int-bool", "smo-result", "bf16"])
def test_same_tree_same_keys_and_npz_bytes(tmp_path, results,
                                           pinned_zip_clock, kind):
    jt, tt = _trees(kind, results)
    extra = {"data": {"seed": 1, "step": 42}}
    mj, bj = _files(jm.save(str(tmp_path / "jax"), 5, jt, extra=extra))
    mt, bt = _files(tm.save(str(tmp_path / "torch"), 5, tt, extra=extra))
    assert mt["keys"] == mj["keys"]
    assert bt == bj
    assert {k: v for k, v in mt.items() if k != "treedef"} == \
        {k: v for k, v in mj.items() if k != "treedef"}
    if kind == "smo-result":
        assert {"res/model/spec/0/0", "res/model/spec/0/1"} <= set(mt["keys"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_crosses_packages_bitwise(tmp_path, results, writer):
    jt, tt = _trees("smo-result", results)
    if writer == "jax":
        jm.save(str(tmp_path), 2, jt)
        got, step = tm.restore_latest(str(tmp_path), tt)
        want = tt
    else:
        tm.save(str(tmp_path), 2, tt)
        got, step = jm.restore_latest(str(tmp_path), jt)
        want = jt
    assert step == 2
    gm, wm = got["res"].model, want["res"].model
    for name in ("gamma", "rho1", "rho2", "X"):
        a, b = np.asarray(getattr(gm, name)), np.asarray(getattr(wm, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("iters", "n_viol", "max_viol", "gap", "converged", "f"):
        a = np.asarray(getattr(got["res"], name))
        b = np.asarray(getattr(want["res"], name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    if writer == "jax":
        k = gm.spec.kernel
        assert type(k.gamma) is float and type(k.coef0) is float
        assert (k.name, k.gamma, k.coef0, k.degree) == ("rbf", 0.5, 0.0, 3)


def test_bf16_round_trips_bitwise_and_reads_jax_bits(tmp_path, results):
    jt, tt = _trees("bf16", results)
    tm.save(str(tmp_path / "torch"), 1, tt)
    got = tm.restore(str(tmp_path / "torch"), 1, tt)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tt["w"].view(torch.int16))
    jm.save(str(tmp_path / "jax"), 1, jt)
    got = tm.restore(str(tmp_path / "jax"), 1, tt)
    assert torch.equal(got["w"].view(torch.int16), tt["w"].view(torch.int16))
    assert torch.equal(got["x"], tt["x"])
    # a bf16 leaf restored into an f32 tensor is its value
    got = tm.restore(str(tmp_path / "jax"), 1, {"w": tt["w"].float(),
                                                "x": tt["x"]})
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], tt["w"].float())


def test_restore_keeps_dtype_and_device_and_places(tmp_path):
    state = {"g": torch.arange(4, dtype=torch.float16),
             "n": torch.tensor(7, dtype=torch.int64),
             "h": np.ones(3, np.float32), "s": 3, "c": None}
    tm.save(str(tmp_path), 1, state)
    like = dict(state, g=torch.zeros(4, dtype=torch.float16))
    got = tm.restore(str(tmp_path), 1, like)
    assert got["g"].dtype == torch.float16 and torch.equal(got["g"],
                                                            state["g"])
    assert got["n"].dtype == torch.int64 and int(got["n"]) == 7
    assert got["h"].dtype == np.float32 and type(got["s"]) is int
    assert got["c"] is None
    cpu = torch.device("cpu")
    placed = tm.restore(str(tmp_path), 1, like,
                        shardings={"g": cpu, "n": None, "h": cpu})
    assert placed["g"].device == cpu and placed["n"].device == cpu
    assert isinstance(placed["h"], torch.Tensor)


def test_latest_and_gc(tmp_path):
    state = {"x": torch.arange(4)}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        ck.save(s, state)
    ck.wait()
    assert tm.latest_step(str(tmp_path)) == 9
    assert tm.latest_step(str(tmp_path / "nowhere")) is None
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000005", "step_000000009"]


def test_corruption_detected(tmp_path):
    state = {"x": torch.arange(10)}
    path = tm.save(str(tmp_path), 3, state)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="corrupt"):
        tm.restore(str(tmp_path), 3, state)


def test_extra_metadata_roundtrip(tmp_path):
    tm.save(str(tmp_path), 11, {"x": torch.zeros(3)},
            extra={"data": {"seed": 1, "step": 42}})
    with open(os.path.join(tmp_path, "step_000000011",
                           "manifest.json")) as f:
        assert json.load(f)["extra"]["data"]["step"] == 42


def test_async_save_snapshots_before_in_place_update(tmp_path, monkeypatch):
    """The write is held back until the caller has updated every leaf in
    place; the file holds the values at ``save``."""
    gate = threading.Event()
    real_save = tm.save

    def held_save(*a, **k):
        assert gate.wait(30)
        return real_save(*a, **k)
    monkeypatch.setattr(tm, "save", held_save)
    state = {"t": torch.arange(6, dtype=torch.float32),
             "b": torch.ones(4, dtype=torch.bfloat16),
             "n": np.arange(3)}
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy()
            for k, v in state.items()}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    fut = ck.save(1, state)
    state["t"].add_(100.0)
    state["b"].mul_(3.0)
    state["n"] += 50
    gate.set()
    fut.result(timeout=30)
    got = tm.restore(str(tmp_path), 1, state)
    assert torch.equal(got["t"], want["t"])
    assert torch.equal(got["b"].view(torch.int16), want["b"].view(torch.int16))
    np.testing.assert_array_equal(got["n"], want["n"])


def test_smo_state_checkpointable_and_warm_restart_converges(tmp_path):
    """Mid-solve SMO state (gamma, rho) is an ordinary tree."""
    X = torch.as_tensor(make_toy(0, 64)[0])
    spec = SlabSpec(nu1=0.5, nu2=0.1, eps=0.5, kernel=rbf(gamma=0.5))
    res = solve_blocked(X, spec, P=4, tol=1e-3, max_outer=3)
    assert not bool(res.converged)
    tree = {"gamma": res.model.gamma, "rho1": res.model.rho1,
            "rho2": res.model.rho2}
    tm.save(str(tmp_path), 1, tree)
    restored, _ = tm.restore_latest(str(tmp_path), tree)
    assert torch.equal(restored["gamma"], tree["gamma"])
    res2 = solve_blocked(X, spec, P=4, tol=1e-3, gamma0=restored["gamma"])
    assert bool(res2.converged)

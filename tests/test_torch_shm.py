"""The port's shared-memory fleet held against the JAX package's.

* A segment published by ``repro.serve.publish`` attaches in
  ``repro_torch`` with every array bitwise the published one, in each
  precision (bf16 travels as its bits under the name "bfloat16"), and
  the other way round; leases of both packages count in one refcount.
* The reference's fleet tests, on the port: an attached model scores
  bitwise like its publisher, refcounts, liveness pruning of a dead
  leader, the last lease unlinking the segment, resource-tracker
  untracking (in process and across a process of its own), the flock
  retry on an unlinked lock inode, ``attach_or_publish`` building once,
  and ``attach`` refusing to run without a card unless asked for the
  CPU.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import repro
import repro.core as jc
from repro.serve import shm_registry as jshm
from repro.serve.model_cache import pack_model as j_pack_model
from repro.kernels.precision import PRECISIONS
from repro_torch.data import make_toy
from repro_torch.serve import ShmKeyError, pack_model
from repro_torch.serve import shm_registry as tshm
from test_torch_serve import _carry

ROOT = Path(__file__).resolve().parents[1]


def _key(tmp_path, name):
    """A key of this test's own: a segment is named by a hash of its key
    in /dev/shm, which every process on the host shares."""
    return f"{tmp_path}/{name}"


@pytest.fixture(scope="module")
def jfit():
    X = make_toy(5, 96)[0]
    spec = jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jc.rbf(0.5))
    return repro.fit(jnp.asarray(X), spec, strategy="blocked",
                     tol=1e-3).model


def _j_bytes(sm):
    """Each manifest array's bytes, as the JAX package lays them out."""
    return {k: a.tobytes() for k, a in jshm._host_arrays(sm).items()}


def _t_bytes(sm):
    t = sm.t_pad.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    rho = torch.stack([sm.model.rho1.float(), sm.model.rho2.float()])
    return {"t_pad": t.numpy().tobytes(),
            "gamma_pad": sm.gamma_pad.cpu().numpy().tobytes(),
            "t_norms": sm.t_norms.cpu().numpy().tobytes(),
            "sv_gamma": sm.model.gamma.cpu().numpy().tobytes(),
            "sv_X": sm.model.X.cpu().numpy().tobytes(),
            "rho": rho.cpu().numpy().tobytes()}


def _same_meta(a, b):
    assert (a.n_sv, a.tn, a.precision, a.fit_iters) == \
        (b.n_sv, b.tn, b.precision, b.fit_iters)
    ka, kb = a.spec.kernel, b.spec.kernel
    assert (a.spec.nu1, a.spec.nu2, a.spec.eps) == \
        (b.spec.nu1, b.spec.nu2, b.spec.eps)
    assert (ka.name, ka.gamma, ka.coef0, ka.degree) == \
        (kb.name, kb.gamma, kb.coef0, kb.degree)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_reference_segment_attaches_bitwise(jfit, precision, tmp_path):
    jsm = j_pack_model(jfit, precision=precision)
    d = str(tmp_path)
    key = _key(tmp_path, "j-key")
    lease = jshm.publish(jsm, key, dir=d)
    try:
        tsm, tlease = tshm.attach(key, dir=d, device="cpu")
        with tlease:
            assert tsm.t_pad.dtype == {"f32": torch.float32,
                                       "bf16": torch.bfloat16,
                                       "f16": torch.float16}[precision]
            assert _t_bytes(tsm) == _j_bytes(jsm)
            _same_meta(tsm, jsm)
            # one refcount across the two packages
            assert tshm.live_refs(key, dir=d) \
                == jshm.live_refs(key, dir=d) == 2
        assert jshm.live_refs(key, dir=d) == 1
    finally:
        lease.close()
    with pytest.raises(ShmKeyError):
        tshm.attach(key, dir=d, device="cpu")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_segment_attaches_bitwise_in_the_reference(jfit, precision,
                                                        tmp_path):
    tsm = pack_model(_carry(jfit), precision=precision)
    d = str(tmp_path)
    key = _key(tmp_path, "t-key")
    lease = tshm.publish(tsm, key, dir=d)
    try:
        jsm, jlease = jshm.attach(key, dir=d)
        with jlease:
            assert _j_bytes(jsm) == _t_bytes(tsm)
            _same_meta(tsm, jsm)
            man = (tmp_path / f"{tshm._digest(key)}.json").read_text()
            assert '"dtype": "%s"' % {"f32": "float32", "bf16": "bfloat16",
                                      "f16": "float16"}[precision] in man
    finally:
        lease.close()
    assert tshm.live_refs(key, dir=d) == 0


# -- the reference's fleet tests, on the port --------------------------------------

@pytest.fixture
def served(jfit):
    return pack_model(_carry(jfit))


def _q(n=7, seed=3):
    return make_toy(40 + seed, n)[0]


def test_attach_scores_bitwise_like_the_publisher(served, tmp_path):
    q = _q()
    ref = served.score(q)
    key = _key(tmp_path, "fleet-key")
    lease = tshm.publish(served, key, dir=str(tmp_path))
    try:
        sm2, lease2 = tshm.attach(key, dir=str(tmp_path),
                                  device="cpu")
        with lease2:
            assert sm2.score(q).tobytes() == ref.tobytes()
        # publishing a published key takes another lease on its segment
        again = tshm.publish(served, key, dir=str(tmp_path))
        assert tshm.live_refs(key, dir=str(tmp_path)) == 2
        again.close()
    finally:
        lease.close()


def test_refcount_attach_detach_unlinks_at_zero(served, tmp_path):
    d = str(tmp_path)
    key = _key(tmp_path, "k")
    lease = tshm.publish(served, key, dir=d)
    _, lease2 = tshm.attach(key, dir=d, device="cpu")
    assert tshm.live_refs(key, dir=d) == 2
    lease2.close()
    lease2.close()                          # double close is a no-op
    assert tshm.live_refs(key, dir=d) == 1
    lease.close()
    assert tshm.live_refs(key, dir=d) == 0
    assert sorted(os.listdir(d)) == []      # manifest, refs, lock gone
    with pytest.raises(ShmKeyError):
        tshm.attach(key, dir=d, device="cpu")


def test_leader_death_is_pruned(served, tmp_path):
    d = str(tmp_path)
    key = _key(tmp_path, "k")
    lease = tshm.publish(served, key, dir=d)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()                             # reaped: the pid is dead
    if tshm._pid_alive(proc.pid):
        pytest.skip("could not obtain a dead pid")
    refs = tmp_path / f"{tshm._digest(key)}.refs"
    refs.write_text('{"pids": [%d]}' % proc.pid)
    assert tshm.live_refs(key, dir=d) == 0
    _, lease2 = tshm.attach(key, dir=d, device="cpu")   # revives the fleet
    assert tshm.live_refs(key, dir=d) == 1
    lease2.close()                          # last LIVE holder out
    with pytest.raises(ShmKeyError):
        tshm.attach(key, dir=d, device="cpu")
    lease._shm.close()                      # our stale mapping
    lease.closed = True


def test_every_open_untracks_from_the_resource_tracker(served, tmp_path,
                                                       monkeypatch):
    from multiprocessing import resource_tracker
    events = []
    real_reg, real_unreg = (resource_tracker.register,
                            resource_tracker.unregister)
    monkeypatch.setattr(resource_tracker, "register", lambda n, r: (
        events.append((+1, n, r)), real_reg(n, r)))
    monkeypatch.setattr(resource_tracker, "unregister", lambda n, r: (
        events.append((-1, n, r)), real_unreg(n, r)))
    d = str(tmp_path)
    key = _key(tmp_path, "tracker-k")
    lease = tshm.publish(served, key, dir=d)
    seg = lease._shm.name

    def balance():
        total = 0
        for s, name, rtype in events:
            if rtype == "shared_memory" and name.lstrip("/") == seg:
                total += s
                assert total >= 0           # no unmatched UNREGISTER
        return total

    assert balance() == 0                   # create path untracks
    _, lease2 = tshm.attach(key, dir=d, device="cpu")
    assert balance() == 0                   # attach too
    lease2.close()
    lease.close()
    assert balance() == 0


def test_attached_worker_exit_does_not_unlink_the_segment(served,
                                                          tmp_path):
    d = str(tmp_path)
    key = _key(tmp_path, "worker-k")
    lease = tshm.publish(served, key, dir=d)
    code = ("from repro_torch.serve import shm_registry\n"
            f"sm, lease = shm_registry.attach({key!r}, dir={d!r}, "
            "device='cpu')\n"
            "assert sm.n_sv > 0\n"
            "lease.close()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    try:
        _, lease2 = tshm.attach(key, dir=d, device="cpu")
        lease2.close()
    finally:
        lease.close()


def test_flock_retries_on_an_unlinked_lock_inode(tmp_path):
    import fcntl
    lock = tmp_path / "x.lock"
    f = open(lock, "a+")
    fcntl.flock(f, fcntl.LOCK_EX)
    f.write("doomed inode")
    f.flush()
    seen = {}

    def contender():
        with tshm._flock(lock):
            seen["content"] = lock.read_text()

    t = threading.Thread(target=contender)
    t.start()
    time.sleep(0.3)             # the contender is parked in flock()
    lock.unlink()               # cleanup retires the inode under the lock
    fcntl.flock(f, fcntl.LOCK_UN)
    f.close()
    t.join(10.0)
    assert not t.is_alive()
    assert seen["content"] == ""            # ran on the fresh inode


def test_attach_or_publish_builds_once(served, tmp_path):
    d = str(tmp_path)
    key = _key(tmp_path, "k")
    builds = []

    def build():
        builds.append(1)
        return served

    sm1, l1 = tshm.attach_or_publish(key, build, dir=d, device="cpu")
    sm2, l2 = tshm.attach_or_publish(key, build, dir=d, device="cpu")
    assert len(builds) == 1 and sm1 is served
    q = _q(seed=4)
    assert sm2.score(q).tobytes() == served.score(q).tobytes()
    l1.close()
    l2.close()


def test_attach_needs_a_card_unless_asked_for_the_cpu(served, tmp_path,
                                                      monkeypatch):
    d = str(tmp_path)
    key = _key(tmp_path, "k")
    lease = tshm.publish(served, key, dir=d)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tshm.attach(key, dir=d)
        assert tshm.live_refs(key, dir=d) == 1     # no lease was taken
        with pytest.raises(ShmKeyError):
            tshm.attach("missing", dir=d, device="cpu")
    finally:
        lease.close()

"""The port's scoring service, admission controller and async driver held
against the JAX package's.

* One request script (two tenants, deadlines, a quota rejection, a
  bucket-fill flush that spans buckets, a dead-deadline inline flush, an
  age-bounded window, a drain) runs in both packages on the same models
  (one JAX fit each, carried into the port) under the same ticking fake
  clock: the same flush log — launches per flush, rejections, next-due
  times, per-bucket counters (launches, rows, requests, cold launches,
  summed seconds) and window counters — and scores within the f32
  ``TOLERANCES``.
* ``ScoringService`` and ``run_request_stream`` give the same per-bucket
  log, and its oversized groups span buckets.
* A registry version bump rebuilds the controller's service and keeps
  its observed latencies; the stub's and the real registry's.
* ``AsyncDriver.step`` and ``serve_async`` on a fake clock, ``__exit__``
  drains, and a failure in the driver thread surfaces as
  ``DriverCrashed``.
"""
import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro.core as jc
import repro.serve as jserve
import repro_torch
import repro_torch.core as tc
import repro_torch.serve as tserve
from repro.kernels.precision import truth_tolerance
from repro.serve.model_cache import pack_model as j_pack_model
from repro_torch.data import make_toy
from test_torch_serve import _carry

M = 96


class TickClock:
    """A fake clock that moves ``dt`` on every read: latencies, due times
    and deadlines are deterministic and nonzero."""

    def __init__(self, t=0.0, dt=1e-3):
        self.t, self.dt = t, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def advance(self, s):
        self.t += s


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class StubRegistry:
    """Anything with ``get``/``quota``/``version`` backs a controller."""

    def __init__(self, models, quotas=None):
        self.models, self.quotas = dict(models), dict(quotas or {})
        self.versions = {}
        self.fail = False

    def get(self, name):
        if self.fail:
            raise RuntimeError("registry down")
        return self.models[name]

    def quota(self, name):
        if name not in self.models:
            raise KeyError(name)
        return self.quotas.get(name)

    def version(self, name):
        return self.versions.get(name, 0)

    def bump(self, name, model):
        self.models[name] = model
        self.versions[name] = self.version(name) + 1


@pytest.fixture(scope="module")
def models():
    """Two tenants fitted once by the JAX package: {name: (jax packed,
    port packed)}."""
    X = make_toy(5, M)[0]
    out = {}
    for name, kern in (("a", jc.rbf(0.5)), ("b", jc.linear())):
        spec = jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=kern)
        res = repro.fit(jnp.asarray(X), spec, strategy="blocked", tol=1e-3)
        out[name] = (j_pack_model(res.model),
                     tserve.pack_model(_carry(res.model)))
    return out


def _q(seed, n):
    return make_toy(100 + seed, n)[0]


def _admission_script(serve_pkg, models):
    """Drive one controller; returns (flush log, {request: scores})."""
    clock = TickClock()
    reg = StubRegistry(models, quotas={"a": 300})
    ctrl = serve_pkg.AdmissionController(
        reg, clock=clock, max_wait_s=0.05, fallback_latency_s=0.002)
    log, out, handles = [], {}, {}

    def sub(tag, model, n, deadline=None):
        try:
            h = ctrl.submit(model, _q(len(handles), n), deadline=deadline)
        except serve_pkg.QuotaExceededError as e:
            log.append(("rejected", tag, e.model, e.quota, e.queued_rows,
                        e.requested_rows))
            return
        handles[tag] = h
        log.append(("admitted", tag, h.flushed, ctrl.queued_rows(model)))

    sub("a10", "a", 10, deadline=clock.t + 0.5)
    sub("b63", "b", 63)
    sub("a200", "a", 200, deadline=clock.t + 0.8)
    sub("a100", "a", 100)                   # 310 > quota 300: rejected
    log.append(("due", ctrl.due("a"), ctrl.due("b"),
                round(ctrl.next_due_time(), 9)))
    clock.advance(0.6)
    log.append(("poll", ctrl.poll()))       # a due (deadline); b aged out
    sub("b4100", "b", 4100)                 # fills the window: flushes
    sub("a30", "a", 30, deadline=clock.t - 1.0)   # born dead: inline
    sub("a65", "a", 65)
    sub("a1", "a", 1)
    log.append(("poll early", ctrl.poll()))
    clock.advance(0.1)
    log.append(("poll aged", ctrl.poll()))
    sub("b256", "b", 256, deadline=clock.t + 10.0)
    try:
        ctrl.submit("zz", _q(0, 3))
    except KeyError as e:
        log.append(("unknown", type(e).__name__))
    try:
        ctrl.submit("a", _q(0, 3)[:, :1])
    except ValueError:
        log.append(("bad width", "ValueError"))
    log.append(("estimate", round(ctrl.estimate_latency_s("b"), 9)))
    log.append(("drain", ctrl.drain()))
    log.append(("stats", ctrl.stats_dict()))
    for tag, h in handles.items():
        assert h.done
        out[tag] = np.asarray(h.result())
    return log, out


def test_admission_flush_log_matches_the_reference(models):
    j_log, j_out = _admission_script(
        jserve, {k: v[0] for k, v in models.items()})
    t_log, t_out = _admission_script(
        tserve, {k: v[1] for k, v in models.items()})
    assert t_log == j_log
    assert t_log[-1][0] == "stats"
    stats = t_log[-1][1]
    assert stats["a"]["rejected"] == 1
    assert set(stats["b"]["buckets"]) == {64, 256, 4096}   # spans buckets
    assert stats["b"]["buckets"][64]["batches"] == 2
    assert stats["a"]["windows"]["inline_flushes"] == 1
    assert sorted(t_out) == sorted(j_out)
    for tag, j in j_out.items():
        t = t_out[tag]
        assert isinstance(t, np.ndarray) and t.shape == j.shape
        np.testing.assert_allclose(t, j, **truth_tolerance("f32", j))


def _service_script(serve_pkg, sm):
    clock = TickClock()
    svc = serve_pkg.ScoringService(sm.scorer(), max_batch=1024,
                                   clock=clock)
    sizes = (1, 63, 64, 65, 500, 2000, 7, 5000, 3)
    reqs = [_q(i, n) for i, n in enumerate(sizes)]
    got = serve_pkg.run_request_stream(svc, reqs, coalesce=4)
    p = svc.submit(_q(50, 5))
    assert not p.done
    got.append(p.result())                  # result() flushes
    return ((svc.stats_dict(), svc.flush_groups,
             round(svc.mean_flush_overhead_s, 9), svc.stats_lines()),
            [np.asarray(g) for g in got])


def test_service_stream_matches_the_reference(models):
    j_log, j_out = _service_script(jserve, models["a"][0])
    t_log, t_out = _service_script(tserve, models["a"][1])
    assert t_log == j_log
    assert set(t_log[0]) == {64, 256, 1024, 4096}   # 5000 rows span two
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t, j, **truth_tolerance("f32", j))
    with pytest.raises(ValueError):
        tserve.ScoringService(models["a"][1].scorer(), max_batch=0)


def test_warmed_buckets_are_never_recorded_cold(models):
    sm = tserve.pack_model(models["a"][1].model)
    svc = tserve.ScoringService(sm.scorer(), clock=TickClock())
    svc.score(_q(1, 10))
    assert svc.stats[64].cold_batches == 1
    svc.warmup()
    assert sm.scorer().warmed_buckets == set(tserve.BUCKETS)
    svc.score(_q(2, 300))
    assert svc.stats[1024].cold_batches == 0


def test_version_bump_rebuilds_the_service(models):
    for pkg, i in ((jserve, 0), (tserve, 1)):
        reg = StubRegistry({"a": models["a"][i]})
        ctrl = pkg.AdmissionController(reg, clock=ManualClock())
        svc1 = ctrl.service("a")
        svc1.stats.setdefault(64, pkg.BucketStats()).record(64, 1, 0.25)
        assert ctrl.service("a") is svc1
        reg.bump("a", models["b"][i])
        svc2 = ctrl.service("a")
        assert svc2 is not svc1 and svc2.scorer.model is models["b"][i]
        assert ctrl.estimate_latency_s("a", 30) == pytest.approx(0.25)


def test_refresh_rebuilds_the_service_of_a_real_registry():
    X = make_toy(5, M)[0]
    spec = tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tc.rbf(0.5))
    reg = tserve.ModelRegistry()
    reg.register("a", X, spec, quota=100, device="cpu", tol=1e-3)
    ctrl = tserve.AdmissionController(reg, clock=ManualClock(),
                                      max_batch=128)
    svc1 = ctrl.service("a")
    h = ctrl.submit("a", X[4:12])
    rng = np.random.default_rng(0)
    reg.refresh("a", append=(X[:12] + rng.normal(0, 1e-3, (12, 2)))
                .astype(np.float32))
    assert reg.quota("a") == 100 and ctrl.queued_rows("a") == 8
    assert ctrl.service("a") is not svc1
    assert ctrl.flush_model("a") == 1 and h.done
    direct = reg.get("a").scorer().score(X[4:12])
    np.testing.assert_allclose(h.result(), direct,
                               **truth_tolerance("f32", direct))


# -- the async driver -----------------------------------------------------------

def test_driver_step_on_a_fake_clock(models):
    clock = ManualClock()
    ctrl = tserve.AdmissionController(StubRegistry({"a": models["a"][1]}),
                                      clock=clock)
    drv = tserve.AsyncDriver(ctrl)
    h = ctrl.submit("a", _q(1, 5), deadline=1.0)
    assert drv.step() == 0 and not h.done
    assert ctrl.next_due_time() == pytest.approx(1.0)
    clock.advance(1.0)
    assert drv.step() == 1 and h.done
    assert h.result().shape == (5,)


def test_serve_async_and_exit_drains_on_a_fake_clock(models):
    ctrl = tserve.AdmissionController(StubRegistry({"a": models["a"][1]}),
                                      clock=ManualClock())
    qs = [_q(i, n) for i, n in enumerate((3, 70, 9))]

    async def main():
        with tserve.AsyncDriver(ctrl) as drv:
            assert drv.alive
            tasks = [asyncio.ensure_future(tserve.serve_async(
                "a", q, controller=ctrl)) for q in qs]
            await asyncio.sleep(0)          # every coroutine admitted
            assert ctrl.queued_rows("a") == 82
        # no deadline, no max_wait: only __exit__'s drain served them
        assert not drv.alive
        return await asyncio.gather(*tasks)

    got = asyncio.run(main())
    assert [g.shape for g in got] == [(3,), (70,), (9,)]
    sm = models["a"][1]
    for g, q in zip(got, qs):
        ref = sm.score(q)
        np.testing.assert_allclose(g, ref, **truth_tolerance("f32", ref))
    assert repro_torch.serve_async is tserve.serve_async


def test_driver_flushes_on_a_deadline_nobody_polls(models):
    ctrl = tserve.AdmissionController(StubRegistry({"a": models["a"][1]}))
    ctrl.service("a")
    with tserve.AsyncDriver(ctrl):
        h = ctrl.submit("a", _q(1, 4), deadline=time.monotonic() + 0.1)
        t0 = time.monotonic()
        while not h.done and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert h.done


def test_driver_failure_surfaces_as_driver_crashed(models):
    reg = StubRegistry({"a": models["a"][1]})
    ctrl = tserve.AdmissionController(reg)
    h = ctrl.submit("a", _q(1, 4), deadline=time.monotonic() + 0.05)
    reg.bump("a", models["a"][1])           # the next flush rebuilds...
    reg.fail = True                         # ...and the registry is down
    drv = tserve.AsyncDriver(ctrl).start()
    t0 = time.monotonic()
    while drv.crashed is None and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    assert isinstance(drv.crashed, tserve.DriverCrashed)
    assert isinstance(drv.crashed.cause, RuntimeError)
    with pytest.raises(tserve.DriverCrashed):
        h.result()
    with pytest.raises(tserve.DriverCrashed):
        drv.stop()
    with pytest.raises(tserve.DriverCrashed):
        drv.start()                         # no silent restart
    # __exit__ prefers the body's exception, and raises the crash after a
    # clean body
    reg2 = StubRegistry({"a": models["a"][1]})
    ctrl2 = tserve.AdmissionController(reg2)
    with pytest.raises(tserve.DriverCrashed):
        with tserve.AsyncDriver(ctrl2) as d2:
            ctrl2.submit("a", _q(2, 4), deadline=time.monotonic() + 0.05)
            reg2.bump("a", models["a"][1])
            reg2.fail = True
            t0 = time.monotonic()
            while d2.crashed is None and time.monotonic() - t0 < 30:
                time.sleep(0.01)


def test_default_driver_is_built_once_and_reset(models):
    reg = StubRegistry({"a": models["a"][1]})
    tserve.reset_default_driver()
    try:
        ctrl, drv = tserve.default_driver(registry=reg)
        assert drv.alive and tserve.default_driver() == (ctrl, drv)
        out = asyncio.run(tserve.serve_async(
            "a", _q(1, 6), deadline=time.monotonic() + 0.05))
        assert out.shape == (6,)
    finally:
        tserve.reset_default_driver()
    assert not drv.alive

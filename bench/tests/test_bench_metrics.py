"""The yardstick's arithmetic: intervals, percentiles, bounds, shares."""
import pytest

from benchlib import readers, trace, yardstick


def test_union_of_intervals():
    assert yardstick.union_seconds([]) == 0
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.union_seconds([(5, 6), (0, 10)]) == 10
    assert yardstick.union_seconds([(0, 1), (1, 2)]) == 2


def test_gaps_cover_what_the_intervals_leave_of_the_window():
    assert yardstick.gaps([(2, 3), (5, 7)], 0, 10) == [(0, 2), (3, 5),
                                                       (7, 10)]
    assert yardstick.gaps([(-1, 4), (3, 11)], 0, 10) == []
    assert yardstick.gaps([], 0, 1) == [(0, 1)]


def test_p95_is_taken_over_every_request():
    lat = list(range(1, 101))          # 1..100
    assert yardstick.percentile(lat, 95) == 95
    assert yardstick.percentile(lat + [1000] * 10, 95) == 1000
    assert yardstick.percentile([7], 95) == 7
    assert yardstick.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_decision_work_and_its_bound():
    # 4096 queries x 65536 support x 128 features, f32
    flops = yardstick.decision_flops(4096, 65536, 128)
    assert flops == 2 * 4096 * 65536 * 128 + 2 * 4096 * 65536
    nbytes = yardstick.decision_bytes(4096, 1, 65536, 128, "f32")
    assert nbytes == 65536 * (512 + 8) + 4096 * (512 + 8)
    assert yardstick.bound_s(flops, nbytes, "f32") == flops / 67e12
    # the 64-row bf16 launch is bound by the support set's bytes
    f = yardstick.decision_flops(64, 32768, 4096)
    b = yardstick.decision_bytes(64, 1, 32768, 4096, "bf16")
    assert yardstick.bound_s(f, b, "bf16") == b / 3.35e12


def _ctx(busy=0.8, window=1.0, kernel_s=0.5, rows=4096, launches=1):
    names = {"void repro::split_simt_kernel<float>(...)": (1, kernel_s),
             "Memcpy HtoD": (1, 0.01)}
    return {"config": {"d": 128, "precision": "f32"},
            "window": {"rows": rows, "launches": launches,
                       "support_rows": 65536},
            "trace": {"busy_s": busy, "window_s": window,
                      "kernels": names}}


def test_roofline_mfu_and_idle_from_a_trace():
    ctx = _ctx()
    bound = yardstick.decision_flops(4096, 65536, 128) / 67e12
    assert readers.decision_roofline(ctx) == pytest.approx(
        100 * bound / 0.5)
    assert readers.mfu(ctx) == pytest.approx(
        100 * yardstick.decision_flops(4096, 65536, 128) / 67e12)
    assert readers.device_idle(ctx) == pytest.approx(20.0)


def test_readers_return_nothing_without_a_trace_or_kernels():
    ctx = _ctx()
    ctx["trace"] = None
    assert readers.decision_roofline(ctx) is None
    assert readers.mfu(ctx) is None
    assert readers.device_idle(ctx) is None
    ctx = _ctx()
    ctx["trace"]["kernels"] = {"Memcpy HtoD": (1, 0.01)}
    assert readers.decision_roofline(ctx) is None
    ctx = _ctx(busy=0.0)
    assert readers.mfu(ctx) is None


def test_service_deltas_are_the_window_s_own():
    before = {"buckets": {"4096": {"batches": 2, "queries": 8000,
                                   "total_s": 0.01}},
              "windows": {"flushed": 2, "flushed_rows": 8000}}
    after = {"buckets": {"4096": {"batches": 5, "queries": 18000,
                                  "total_s": 0.04},
                         "1024": {"batches": 1, "queries": 1000,
                                  "total_s": 0.002}},
             "windows": {"flushed": 6, "flushed_rows": 19000}}
    ctx = {"window": {"stats_before": before, "stats_after": after}}
    d = readers.service_launches(ctx)
    assert d["batches"] == 4 and d["queries"] == 11000
    assert d["bucket_rows"] == 3 * 4096 + 1024
    assert d["total_s"] == pytest.approx(0.032)
    assert readers.admission_windows(ctx) == {"flushed": 4,
                                              "flushed_rows": 11000}


def test_trace_summary_clips_to_the_window_and_names_the_gaps():
    ns = 1_000_000_000
    events = [(trace.WINDOW, False, 1 * ns, 3 * ns),
              ("kernel_a", True, 0, int(1.5 * ns)),          # clipped
              ("kernel_b", True, 2 * ns, int(2.5 * ns)),
              ("aten::copy_", False, int(1.5 * ns), 2 * ns),
              ("outer", False, int(1.4 * ns), int(2.6 * ns)),
              ("kernel_c", True, 4 * ns, 5 * ns)]            # outside
    s = trace.summarize(events)
    assert s["window_s"] == 2.0
    assert s["busy_s"] == pytest.approx(1.0)
    assert s["kernels"]["kernel_a"] == (1, 0.5)
    assert "kernel_c" not in s["kernels"]
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 1.5-2.0: covered wholly by aten::copy_ and outer, the inner wins
    assert gaps["aten::copy_"] == pytest.approx(0.5)
    # 2.5-3.0: outer covers 0.1 of it, less than half
    assert gaps["(no host span)"] == pytest.approx(0.5)
    assert "outer" not in gaps
    assert s["breakdown"]["device_ops"][0][0] == "kernel_a"


def test_trace_summary_needs_its_window_span():
    with pytest.raises(RuntimeError):
        trace.summarize([("k", True, 0, 1)])

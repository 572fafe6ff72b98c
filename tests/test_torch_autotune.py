"""The port's tile table and autotuner (``repro_torch.kernels.tiling``,
``repro_torch.kernels.autotune``, ``repro_torch.utils.roofline``), on the
CPU, case by case beside tests/test_autotune.py: round trip and merge,
eager rejection of bad tables (the port's own menu errors), exact and
nearest lookup (held against the JAX package's choice on shared
entries), the resolution precedence, the defaults of an empty table, the
cost model, the feasibility model and the committed table.

The two packages validate different tables (the JAX package wants
128-multiples and depths 2/4, the port its menus and classes), so the
lookups are compared on the same raw entries through
``tiling.nearest_entry``, and each package's validation is tested on its
own. Timing needs the card: ``sweep`` raises here, and the card's tests
(tests/test_torch_gpu.py) launch every menu entry.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from repro.kernels import tiling as jtil
from repro.kernels.autotune import FULL_CELLS as J_FULL_CELLS
from repro.kernels.autotune import cost_model as j_cost_model
import repro_torch.core.kernel_fn as tkf
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import tiling as ttil
from repro_torch.kernels.fupdate import ops as tfup
from repro_torch.utils import roofline

CSRC = Path(ttil.__file__).resolve().parents[1] / "csrc"


def _entry(family="fupdate", m=512, d=16, precision="f32", backend="cuda",
           block_m=16, block_n=32, block_k=32, tr=1, tc=2, depth=1,
           **extra):
    e = dict(family=family, m=m, d=d, precision=precision, backend=backend,
             block_m=block_m, block_n=block_n, block_k=block_k, tr=tr,
             tc=tc, depth=depth)
    e.update(extra)
    return e


def _table(*entries):
    return {"version": 1, "entries": list(entries)}


@pytest.fixture(autouse=True)
def _restore_tables():
    yield
    ttil.set_tuned_table(None)
    jtil.set_tuned_table(None)


# ---------------------------------------------------------------------------
# menus: the Python lists against the CUDA sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ttil.FAMILIES)
def test_menus_match_the_cuda_sources(family):
    """Every ``case`` line of the source, in order, is the menu entry of
    its index and launches the kernel ``tiling.kernel_of`` names; the
    tensor-core lines (wgmma; the split kernels' streamed entries too)
    sit in the 16-bit switch and nothing else does, in every family."""
    src = (CSRC / f"{family}.cu").read_text()
    n_case = len(re.findall(r"^\s*case \d+:", src, re.M))
    cases = re.findall(r"^\s*case (\d+): return launch_(\w+)<T, (\d+), "
                       r"(\d+), (\d+), (\d+), (\d+), (\d+)>\(a, st\);$",
                       src, re.M)
    assert len(cases) == n_case > 0      # every menu line is read
    assert [int(c[0]) for c in cases] == list(range(len(cases)))
    entries = tuple(tuple(int(v) for v in c[2:]) for c in cases)
    assert entries == ttil.MENUS[family]
    for (_, kind, *_), entry in zip(cases, entries):
        assert kind == ttil.kernel_of(family, ttil.config_of(entry))
    f32_part, b16_part = src.split("int launch_16bit(")
    assert all(k not in ttil.WGMMA_KERNELS for _, k, *_ in re.findall(
        r"case (\d+): return launch_(\w+)<", f32_part))
    assert {k for _, k, *_ in re.findall(
        r"case (\d+): return launch_(\w+)<()", b16_part)} == (
        {"wgmma"} if family == "gram" else {"wgmma", "stream"})
    dk = re.search(r"constexpr int DK = (\d+);",
                   (CSRC / "kernel_rows.cuh").read_text())
    assert int(dk.group(1)) == ttil.DK


def test_menu_classes_keep_each_sum_order():
    """fupdate/decision classes share BN and TC (the bitwise rule), gram's
    one kind of kernel; the defaults are the first entries of their
    classes, and the classes of a family cover its menu once."""
    for family, n in (("fupdate", 16), ("fupdate", 2048), ("decision", 9)):
        cls = ttil.menu(family, n)
        dflt = ttil.default_config(family, n)
        assert {(c.block_n, c.tc) for c in cls} == {(dflt.block_n, dflt.tc)}
        assert cls[0].entry == dflt.entry
    for precision in ("f32", "bf16", "f16"):
        cls = ttil.menu("gram", precision=precision)
        assert cls[0].entry == ttil.default_config(
            "gram", precision=precision).entry
    assert len(ttil.menu("gram", precision="f32")) \
        + len(ttil.menu("gram", precision="bf16")) == len(ttil.MENUS["gram"])
    assert ttil.menu("gram", precision="bf16") \
        == ttil.menu("gram", precision="f16")
    assert len(ttil.menu("fupdate", 32)) + len(ttil.menu("fupdate", 33)) \
        + len(ttil.menu("fupdate", 33, "bf16")) == len(ttil.MENUS["fupdate"])
    assert ttil.menu("fupdate", 2048, "bf16") \
        == ttil.menu("fupdate", 2048, "f16")
    for precision in ("f32", "bf16", "f16"):    # the narrow class: any type
        assert ttil.menu("fupdate", 32, precision) == ttil.menu("fupdate",
                                                                 32)


@pytest.mark.parametrize("precision,kinds", [
    ("f32", {"tile", "simt"}), ("bf16", {"wgmma"}), ("f16", {"wgmma"})])
def test_gram_class_follows_the_precision(precision, kinds):
    """f32 gram launches resolve to the SIMT class, bf16/f16 ones to the
    wgmma class: with no table, from the table, and by explicit tiles;
    the source compiles each entry for its class's precisions only."""
    cls = ttil.menu("gram", precision=precision)
    assert {ttil.kernel_of("gram", c) for c in cls} == kinds
    assert all(precision in ttil.precisions_of("gram", c) for c in cls)
    ttil.set_tuned_table({"entries": []})
    kw = dict(m=8192, d=128, precision=precision, backend="cuda")
    dflt = ttil.resolve_tiles("gram", **kw)
    assert ttil.kernel_of("gram", dflt) in kinds
    assert dflt.source == "default"
    other = [c for c in cls if (c.block_m, c.block_n, c.block_k)
             != (dflt.block_m, dflt.block_n, dflt.block_k)][0]
    assert ttil.resolve_tiles("gram", **kw, block_m=other.block_m,
                              block_n=other.block_n,
                              block_k=other.block_k).entry == other.entry
    ttil.set_tuned_table(_table(_entry(
        family="gram", m=8192, d=128, precision=precision,
        **{k: getattr(other, k) for k in ("block_m", "block_n", "block_k",
                                          "tr", "tc", "depth")})))
    hit = ttil.resolve_tiles("gram", **kw)
    assert hit.entry == other.entry and hit.source == "table-exact"


@pytest.mark.parametrize("precision,kind,sw", [
    ("f32", "simt", 64), ("bf16", "wgmma", 32), ("f16", "wgmma", 32)])
def test_decision_class_follows_the_precision(precision, kind, sw):
    """decision's f32 launches take the SIMT class (SW = 64 support rows a
    split), bf16/f16 ones the wgmma class (SW = 32, its streamed entry
    among them); the classes share no entry, cover the menu, and vary
    only what leaves the sum order alone (BM, TR, the ring's depth, a
    wgmma's width, a resident or streamed query tile)."""
    cls = ttil.menu("decision", precision=precision)
    assert {ttil.kernel_of("decision", c) for c in cls} == (
        {kind} if kind == "simt" else {"wgmma", "stream"})   # any d
    assert {(c.block_n, c.block_k) for c in cls} == {(sw, cls[0].block_k)}
    if kind == "simt":      # eight columns a thread
        assert {c.tc for c in cls} == {8}
    else:                   # a wgmma covers whole splits
        assert all(4 * c.tc % sw == 0 for c in cls)
        assert len({c.tc for c in cls}) > 1
    assert all(precision in ttil.precisions_of("decision", c) for c in cls)
    assert ttil.default_config("decision", precision=precision).entry \
        == cls[0].entry
    f32, b16 = (ttil.menu("decision", precision=p) for p in ("f32", "bf16"))
    assert not {c.entry for c in f32} & {c.entry for c in b16}
    assert len(f32) + len(b16) == len(ttil.MENUS["decision"])
    ttil.set_tuned_table({"entries": []})
    cfg = ttil.resolve_tiles("decision", m=8192, d=128, n=4096,
                             precision=precision, backend="cuda")
    assert ttil.kernel_of("decision", cfg) == kind
    other = cls[1]
    assert ttil.resolve_tiles("decision", m=8192, d=128, n=4096,
                              precision=precision, backend="cuda",
                              block_m=other.block_m).block_m \
        == other.block_m


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("bucket", [64, 256, 1024, 4096])
def test_packed_decision_rule_picks_an_entry_of_the_class(bucket,
                                                          precision):
    """The packed path's entry is one of the precision's class at every
    bucket (so a query's value does not depend on its bucket), and at
    the smallest bucket against the served model's 8192 support rows its
    grid puts a CTA on each of the H100's 132 SMs."""
    cfg = ttil.packed_decision_config(bucket, precision)
    assert cfg.source == "bucket"
    assert cfg.entry in {c.entry for c in ttil.menu(
        "decision", precision=precision)}
    qtiles, groups = ttil.decision_grid(bucket, 8192, cfg)
    assert qtiles * groups >= tat.H100_SMS
    if bucket >= 1024:
        assert cfg.block_m == 128       # the largest query tile
    small = ttil.packed_decision_config(64, precision)
    assert small.block_m <= cfg.block_m


@pytest.mark.parametrize("precision,splits", [("f32", 128), ("bf16", 256),
                                              ("f16", 256)])
@pytest.mark.parametrize("bucket", [64, 4096])
def test_decision_workspace_for_the_served_shapes(monkeypatch, precision,
                                                  splits, bucket):
    """The launch's workspace is (splits, queries) f32 with
    splits = ceil(support rows / SW), for the served model's 8192 packed
    support rows; ragged counts round up, and no support row means no
    split."""
    import types
    from repro_torch.kernels.decision import ops as tdec
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    ops = tdec.prepare_packed(torch.zeros((bucket, 128)),
                              torch.zeros((8192, 128)),
                              torch.ones((8192, 1)), torch.ones((8192, 1)),
                              tm=min(bucket, 256), tn=512,
                              precision=precision)
    cfg = ttil.packed_decision_config(bucket, precision)
    launch = tdec.launch(*ops, 0.1, 0.9, tkf.rbf(0.5), cfg)
    assert tuple(launch.scratch.shape) == (splits, bucket)
    assert launch.scratch.dtype == torch.float32
    assert launch.scratch.data_ptr() in launch.args
    assert ttil.decision_splits(8192, cfg) == splits
    sw = cfg.block_n
    assert ttil.decision_splits(8192 + 1, cfg) == splits + 1
    assert ttil.decision_splits(sw - 1, cfg) == 1
    assert ttil.decision_splits(0, cfg) == 0
    qtiles, groups = ttil.decision_grid(bucket, 8192, cfg)
    assert qtiles == -(-bucket // cfg.block_m)
    assert groups <= splits
    if ttil.kernel_of("decision", cfg) == "wgmma":     # runs of chunks
        assert groups <= 8192 // (4 * cfg.tc)


@pytest.mark.parametrize("precision,kinds,sw", [
    ("f32", {"simt"}, 64), ("bf16", {"wgmma", "stream"}, 32),
    ("f16", {"wgmma", "stream"}, 32)])
def test_fupdate_wide_class_follows_the_precision(precision, kinds, sw):
    """fupdate above S = 32 takes decision's split classes by the rows'
    type: f32 the SIMT split tile (SW = 64, eight columns a thread),
    bf16/f16 the wgmma split kernel (SW = 32, whole splits a chunk);
    its keys and default depend on the precision, the narrow class's
    not, and each entry is compiled for its class's types only."""
    cls = ttil.menu("fupdate", 33, precision)
    assert {ttil.kernel_of("fupdate", c) for c in cls} == kinds
    assert {c.block_n for c in cls} == {sw}
    assert all(4 * c.tc % sw == 0 for c in cls) if sw == 32 \
        else {c.tc for c in cls} == {8}
    assert all(precision in ttil.precisions_of("fupdate", c) for c in cls)
    dflt = ttil.default_config("fupdate", 128, precision)
    assert dflt.entry == cls[0].entry and dflt.source == "default"
    assert dflt == (ttil.FUPDATE_WIDE_DEFAULT if precision == "f32"
                    else ttil.FUPDATE_WGMMA_DEFAULT)
    narrow = {c.entry for c in ttil.menu("fupdate", 32, precision)}
    assert not narrow & {c.entry for c in cls}
    assert all(ttil.precisions_of("fupdate", ttil.config_of(e))
               == ttil.PRECISIONS for e in narrow)
    ttil.set_tuned_table({"entries": []})
    for s in (33, 128, 433, 2048):
        cfg = ttil.resolve_tiles("fupdate", m=8192, d=128, n=s,
                                 precision=precision, backend="cuda")
        assert cfg == dflt
    # the same split rule as decision's
    assert ttil.fupdate_splits(128, dflt) == 128 // sw
    assert ttil.fupdate_splits(433, dflt) == -(-433 // sw)
    assert ttil.fupdate_splits(0, dflt) == 0
    assert ttil.fupdate_splits(32, ttil.default_config("fupdate", 32)) == 0


@pytest.mark.parametrize("precision,s,splits", [
    ("f32", 128, 2), ("bf16", 128, 4), ("f16", 433, 14), ("f32", 20, 0),
    ("bf16", 0, 0)])
def test_fupdate_workspace_is_splits_by_rows(monkeypatch, precision, s,
                                             splits):
    """A wide fupdate launch owns a (splits, m) f32 workspace, splits =
    ceil(S / SW) (SW = 64 in f32, 32 in 16 bits), passed to the C entry
    after the norms; a narrow launch (S <= 32) one of no rows."""
    import types
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    m = 500
    x = torch.randn(m, 24, generator=torch.Generator().manual_seed(0))
    ops = tfup.prepare(x, x[:s], torch.ones(s), torch.zeros(m),
                       precision=precision)
    cfg = ttil.default_config("fupdate", max(s, 33) if splits else s,
                              precision)
    launch = tfup.launch(*ops, tkf.rbf(0.5), cfg)
    assert tuple(launch.scratch.shape) == (splits, m)
    assert launch.scratch.dtype == torch.float32
    assert launch.args[6] == launch.scratch.data_ptr()
    assert ttil.fupdate_splits(s, cfg) == splits


# The largest padded d each 16-bit split entry keeps resident (the
# kMaxSmem arithmetic of csrc/split_rows.cuh).
_CAPS = {(64, 32, 64, 2, 8, 4): 1664, (128, 32, 64, 2, 8, 4): 832,
         (128, 32, 64, 2, 16, 4): 768, (128, 32, 64, 2, 32, 2): 768,
         (128, 32, 64, 2, 32, 4): 640}


def test_wgmma_fits_caps_each_resident_entry():
    for family in ("decision", "fupdate"):
        for entry in ttil.MENUS[family]:
            cfg = ttil.config_of(entry)
            if ttil.kernel_of(family, cfg) == "wgmma":
                cap = _CAPS[entry]
                assert ttil.wgmma_fits(cfg, cap)
                assert ttil.wgmma_fits(cfg, cap - 63)
                assert not ttil.wgmma_fits(cfg, cap + 1)
                assert ttil.wgmma_smem_bytes(cfg, cap) <= ttil.MAX_SMEM \
                    < ttil.wgmma_smem_bytes(cfg, cap + 64)
            else:       # SIMT, row tiles and the streamed entry: any d
                assert ttil.wgmma_fits(cfg, 1 << 16)
    src = (CSRC / "split_rows.cuh").read_text()
    assert "(STREAM ? DEPTH : nk) * BM * BK * 2 + DEPTH * NW * BK * 2 + " \
        "1024 +\n         8 * (2 * DEPTH + 1)" in src
    assert int(re.search(r"kMaxSmem = (\d+);", (CSRC / "kernel_rows.cuh")
                         .read_text()).group(1)) == ttil.MAX_SMEM
    assert ttil.STREAMED in ttil.MENUS["decision"] \
        and ttil.STREAMED in ttil.MENUS["fupdate"]
    # the wide streamed entry: decision's only, streamed at any d, one CTA
    # an SM, its ring sized as launch_split_cluster sizes it
    wide = ttil.config_of(ttil.STREAMED_WIDE)
    assert ttil.STREAMED_WIDE in ttil.MENUS["decision"] \
        and ttil.STREAMED_WIDE not in ttil.MENUS["fupdate"]
    assert ttil.kernel_of("decision", wide) == "stream"
    for d in (128, 4096, 1 << 16):
        assert ttil.wgmma_smem_bytes(wide, d) == \
            4 * (128 + 256) * 64 * 2 + 1024 + 8 * 9
        assert ttil.wgmma_fits(wide, d)
    assert 2 * ttil.wgmma_smem_bytes(wide, 4096) > 228 * 1024
    assert "constexpr int smem = split_wgmma_smem_bytes<BM, NW, BK, DEPTH, " \
        "true>(1);" in src
    assert "constexpr int kClusterCtas = %d;" % ttil.CLUSTER_CTAS in src


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [128, 640, 768, 832, 896, 1664, 2048, 4096])
def test_packed_decision_config_fits_d(precision, d):
    """At every bucket the packed path's entry is of the precision's
    class and fits d; up to d = 640 it is the entry of d = 128 (the
    parent's choice), and a 16-bit model above 1664 streams (below it,
    wherever the bucket's resident entry does not fit)."""
    for bucket in (64, 256, 1024, 4096):
        cfg = ttil.packed_decision_config(bucket, precision, d)
        assert cfg.source == "bucket"
        assert cfg.entry in {c.entry for c in ttil.menu(
            "decision", precision=precision)}
        assert ttil.wgmma_fits(cfg, d)
        if d <= 640:
            assert cfg == ttil.packed_decision_config(bucket, precision)
        if precision != "f32" and d > 1664:
            assert ttil.kernel_of("decision", cfg) == "stream"
        # against the pooled screen's 32768 support rows: the same class,
        # either streamed entry where the resident one does not fit
        wide = ttil.packed_decision_config(bucket, precision, d, 32768)
        assert wide.entry in {c.entry for c in ttil.menu(
            "decision", precision=precision)}
        assert ttil.wgmma_fits(wide, d)
        if ttil.kernel_of("decision", cfg) != "stream":
            assert wide == cfg
        else:
            assert ttil.kernel_of("decision", wide) == "stream"


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_packed_decision_takes_the_wide_streamed_entry_where_it_fills(
        precision):
    """At d = 4096 the top bucket against 32768 support rows (the pooled
    screen) takes the wide streamed entry, and so does every bucket whose
    wide grid has WIDE_MIN_CTAS CTAs; the 64-row bucket against the
    served model's 8192 support rows, the [lm] slab scores (1024 queries,
    2048 support rows, d = 3072), a ragged 300-row support set, or no
    support count given keep STREAMED."""
    top = ttil.packed_decision_config(4096, precision, 4096, 32768)
    assert top.entry == ttil.STREAMED_WIDE and top.source == "bucket"
    wide = ttil.config_of(ttil.STREAMED_WIDE)
    for bucket, nt, d in ((64, 32768, 4096), (256, 32768, 4096),
                          (1024, 32768, 4096), (4096, 4096, 4096),
                          (1024, 4096, 768), (4096, 32768, 2048)):
        qtiles, groups = ttil.decision_grid(bucket, nt, wide)
        assert qtiles * groups >= ttil.WIDE_MIN_CTAS
        assert ttil.packed_decision_config(bucket, precision, d,
                                           nt).entry == ttil.STREAMED_WIDE
    for bucket, nt, d in ((64, 8192, 4096), (256, 8192, 4096),
                          (64, 4096, 2048), (1024, 2048, 3072),
                          (4096, 300, 4096), (4096, None, 4096)):
        if nt is not None:
            qtiles, groups = ttil.decision_grid(bucket, nt, wide)
            assert qtiles * groups < ttil.WIDE_MIN_CTAS
        assert ttil.packed_decision_config(bucket, precision, d,
                                           nt).entry == ttil.STREAMED
    # the wrapper's default and the table-free resolution agree
    assert ttil.default_config("decision", 4096, precision, 4096,
                               32768).entry == ttil.STREAMED_WIDE
    assert ttil.default_config("decision", 64, precision, 4096,
                               8192).entry == ttil.STREAMED
    ttil.set_tuned_table({"entries": []})
    assert ttil.resolve_tiles("decision", m=32768, d=4096, n=4096,
                              precision=precision,
                              backend="cuda").entry == ttil.STREAMED_WIDE
    # resident entries are untouched
    assert ttil.packed_decision_config(4096, precision, 640, 32768) \
        == ttil.packed_decision_config(4096, precision)


@pytest.mark.parametrize("nq,groups,ctas", [(4096, 4, 128), (4000, 4, 128),
                                            (4224, 3, 102), (64, 64, 128)])
def test_wide_streamed_grid_is_one_wave(nq, groups, ctas):
    """The wide entry's grid: query tiles rounded up to whole clusters x
    runs of 256-row chunks, at most one CTA on each of the card's 132
    SMs, as launch_split_cluster lays it out from the clusters the card
    holds at once (66 when all SMs pair up)."""
    wide = ttil.config_of(ttil.STREAMED_WIDE)
    qtiles, got = ttil.decision_grid(nq, 32768, wide)
    assert qtiles % ttil.CLUSTER_CTAS == 0
    assert qtiles == -(-nq // 256) * 2
    assert (got, qtiles * got) == (groups, ctas)
    assert qtiles * got <= tat.H100_SMS
    chunks = 32768 // 256
    per_cta = -(-chunks // got)
    assert -(-chunks // per_cta) == got      # no empty run
    assert ttil.decision_grid(4096, 300, wide) == (32, 2)   # 2 chunks
    src = (CSRC / "split_rows.cuh").read_text()
    for line in ("const int pairs = (qtiles + kClusterCtas - 1) / "
                 "kClusterCtas;", "int groups = most / pairs;",
                 "if (groups < 1) groups = 1;",
                 "if (groups > chunks) groups = chunks;",
                 "kernel<<<kClusterCtas * pairs * groups, threads, smem, "
                 "stream>>>("):
        assert line in src


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("d", [2048, 4096])
def test_packed_and_default_decision_take_one_streamed_entry(precision, d):
    """The packed launch and the wrapper's default pick the streamed entry
    by one rule: the wide one exactly where its grid has WIDE_MIN_CTAS
    CTAs, over the buckets and support counts either side of it."""
    wide = ttil.config_of(ttil.STREAMED_WIDE)
    for bucket in (64, 256, 1024, 2304, 4096):
        for nt in (300, 1024, 2048, 4096, 8192, 32768):
            qtiles, groups = ttil.decision_grid(bucket, nt, wide)
            want = (ttil.STREAMED_WIDE if qtiles * groups
                    >= ttil.WIDE_MIN_CTAS else ttil.STREAMED)
            assert ttil.packed_decision_config(bucket, precision, d,
                                               nt).entry == want
            assert ttil.default_config("decision", bucket, precision, d,
                                       nt).entry == want


def test_wide_grid_takes_the_clusters_the_card_holds():
    """decision_grid sizes the wide grid from wide_clusters (sms // 2), as
    launch_split_cluster sizes it from split_cluster_capacity, the query
    decision_wide_clusters exports for case 10."""
    wide = ttil.config_of(ttil.STREAMED_WIDE)
    assert ttil.wide_clusters() == 66 and ttil.wide_clusters(114) == 57
    assert ttil.decision_grid(4096, 32768, wide, sms=114) == (32, 3)
    assert ttil.decision_grid(4096, 32768, wide) == (32, 4)
    src = (CSRC / "split_rows.cuh").read_text()
    assert "err = split_cluster_capacity<T, BM, BN, BK, TR, TC, DEPTH>(" \
        "&most);" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    dec = (CSRC / "decision.cu").read_text()
    case = "case 10: return launch_stream<T, %d, %d, %d, %d, %d, %d>(a, st);"
    assert case % ttil.STREAMED_WIDE in dec
    assert ttil.menu_index("decision", wide) == 10
    for t in ("__nv_bfloat16", "__half"):
        assert "split_cluster_capacity<%s, %d, %d, %d, %d, %d, %d>(" % (
            (t,) + ttil.STREAMED_WIDE) in dec


def test_fupdate_menu_and_choices_are_unchanged_by_the_wide_entry():
    """fupdate keeps its menu and STREAMED for 16-bit launches whose
    resident tile does not fit d (the [lm] init pass: m = S = 2048,
    d = 3072), whatever the row counts."""
    assert ttil.MENUS["fupdate"] == (
        (64, 32, 32, 4, 2, 1), (16, 32, 32, 1, 2, 1), (64, 32, 32, 4, 2, 4),
        (32, 32, 32, 2, 2, 4), (16, 32, 32, 1, 2, 4), (64, 64, 8, 4, 8, 2),
        (128, 64, 8, 8, 8, 2), (32, 64, 8, 4, 8, 2), (16, 64, 8, 4, 8, 2),
        (128, 32, 64, 2, 8, 4), (64, 32, 64, 2, 8, 4),
        (128, 32, 64, 2, 16, 4), (128, 32, 64, 2, 32, 4),
        (128, 32, 64, 2, 16, 3))
    ttil.set_tuned_table({"entries": []})
    for m, s in ((2048, 2048), (65536, 32768)):
        for precision in ("bf16", "f16"):
            got = ttil.resolve_tiles("fupdate", m=m, d=3072, n=s,
                                     precision=precision, backend="cuda")
            assert got.entry == ttil.STREAMED
            assert ttil.default_config("fupdate", s, precision, 3072,
                                       m).entry == ttil.STREAMED
    assert "launch_split_cluster" not in (CSRC / "fupdate.cu").read_text()


@pytest.mark.parametrize("family,n", [("decision", 4096), ("fupdate", 128)])
@pytest.mark.parametrize("d", [128, 768, 896, 1664, 2048])
def test_resolve_tiles_never_returns_an_entry_that_does_not_fit(family, n,
                                                               d):
    """The default, the table (even an exact row) and explicit tiles
    take only 16-bit entries whose resident tile fits d."""
    kw = dict(m=8192, d=d, n=n, precision="bf16", backend="cuda")
    cls = ttil.menu(family, n, "bf16")
    ttil.set_tuned_table({"entries": []})
    dflt = ttil.resolve_tiles(family, **kw)
    assert ttil.wgmma_fits(dflt, d) and dflt.entry in {c.entry for c in cls}
    assert dflt == ttil.default_config(family, n, "bf16", d, kw["m"])
    if d <= 832:
        assert dflt.entry == cls[0].entry
    for c in cls:                   # a table row naming each entry
        ttil.set_tuned_table(_table(_entry(
            family=family, m=8192, d=d, precision="bf16",
            **{k: getattr(c, k) for k in ("block_m", "block_n", "block_k",
                                          "tr", "tc", "depth")})))
        got = ttil.resolve_tiles(family, **kw)
        assert ttil.wgmma_fits(got, d)
        assert (got.entry == c.entry) == ttil.wgmma_fits(c, d)
        assert got.source == ("table-exact" if ttil.wgmma_fits(c, d)
                              else "default")
    ttil.set_tuned_table({"entries": []})
    if d > 1664:                    # BM = 64 is resident only
        with pytest.raises(ValueError, match="menu"):
            ttil.resolve_tiles(family, **kw, block_m=64)
    else:
        narrowest = ttil.resolve_tiles(family, **kw, block_m=64)
        assert narrowest.block_m == 64 and ttil.wgmma_fits(narrowest, d)
        assert ttil.kernel_of(family, narrowest) == "wgmma"


def test_new_narrow_fupdate_entries_lie_in_the_narrow_class():
    pipes = [ttil.config_of(e) for e in ttil.MENUS["fupdate"]
             if ttil.kernel_of("fupdate", ttil.config_of(e)) == "pipe"]
    assert len(pipes) == 3
    narrow = {c.entry for c in ttil.menu("fupdate", 32)}
    wide = {c.entry for c in ttil.menu("fupdate", 33)}
    for c in pipes:
        assert c.entry in narrow and c.entry not in wide
        assert (c.block_n, c.tc, c.block_k) == (32, 2, ttil.DK)
        assert c.depth > 1
    assert ttil.default_config("fupdate", 32).depth == 1   # the oracle


@pytest.mark.parametrize("family,a,b", [
    ("fupdate", (16, 32, 32, 1, 2, 1), (16, 32, 32, 1, 2, 4)),   # depth
    ("fupdate", (64, 32, 32, 4, 2, 1), (64, 32, 32, 4, 2, 4)),   # depth
    ("gram", (128, 256, 64, 2, 64, 3), (128, 256, 64, 2, 64, 2)),  # depth
    ("gram", (128, 128, 8, 8, 8, 2), (128, 128, 64, 2, 32, 4)),  # block_k
])
def test_entries_differing_in_depth_or_block_k_have_their_own_index(
        family, a, b):
    ia = ttil.menu_index(family, ttil.config_of(a))
    ib = ttil.menu_index(family, ttil.config_of(b))
    assert ia != ib
    assert ttil.MENUS[family][ia] == a and ttil.MENUS[family][ib] == b


def test_menu_index_refuses_off_menu_configs():
    assert ttil.menu_index("fupdate", ttil.FUPDATE_WIDE_DEFAULT) == 5
    assert ttil.menu_index("gram", ttil.GRAM_WGMMA_DEFAULT) == 2
    for bad in (ttil.TileConfig(64, 32, 64, 4, 2),          # block_k
                ttil.TileConfig(64, 32, 32, 4, 2, depth=2),
                ttil.TileConfig(48, 32, 32, 4, 2)):
        with pytest.raises(ValueError, match="menu"):
            ttil.menu_index("fupdate", bad)
    with pytest.raises(ValueError, match="family"):
        ttil.menu_index("nope", ttil.DEFAULT_CONFIGS["gram"])


# ---------------------------------------------------------------------------
# table loading / validation / round-trip
# ---------------------------------------------------------------------------

def test_write_table_roundtrip(tmp_path):
    path = tmp_path / "tuned.json"
    doc = tat.write_table([_entry(block_m=16, tr=1, best_s=1e-6)], path)
    assert path.exists() and len(doc["entries"]) == 1
    ttil.set_tuned_table(str(path))
    cfg = ttil.lookup_tuned("fupdate", 512, 16, "f32", "cuda", n=16)
    assert cfg == ttil.TileConfig(16, 32, 32, 1, 2, 1, "table-exact")


def test_write_table_merges_on_key(tmp_path):
    path = tmp_path / "tuned.json"
    tat.write_table([_entry(block_m=16, tr=1),
                     _entry(family="gram", block_m=64, block_n=64, tr=4,
                            tc=4)], path)
    # same key -> replaced; new key -> appended
    doc = tat.write_table([_entry(block_m=64, tr=4),
                           _entry(m=1024, block_m=64, tr=4, depth=4)], path)
    keys = {(e["family"], e["m"]) for e in doc["entries"]}
    assert keys == {("fupdate", 512), ("gram", 512), ("fupdate", 1024)}
    by_m = {e["m"]: e for e in doc["entries"] if e["family"] == "fupdate"}
    assert by_m[512]["block_m"] == 64 and by_m[1024]["depth"] == 4


def test_write_table_refuses_a_bad_entry(tmp_path):
    with pytest.raises(ValueError, match="menu"):
        tat.write_table([_entry(block_m=100)], tmp_path / "t.json")
    assert not (tmp_path / "t.json").exists()


@pytest.mark.parametrize("bad", [
    _entry(block_m=100),                       # not on the menu
    _entry(block_m=64, block_n=64, tr=2, tc=4),  # BM/BN pair off the menu
    _entry(family="nope"),                     # unknown family
    _entry(depth=3),                           # depth off the menu
    _entry(block_k=128),                       # block_k off the menu
    _entry(family="gram", precision="bf16", block_m=64, block_n=64,
           tr=4, tc=4),                        # SIMT entry, bf16 rows
    _entry(family="gram", precision="f32", block_m=128, block_n=256,
           block_k=64, tr=2, tc=64, depth=4),  # wgmma entry, f32 rows
    _entry(family="gram", precision="f64", block_m=64, block_n=64,
           tr=4, tc=4),                        # no such precision
    _entry(family="decision", block_m=16, block_n=32, tr=1, tc=4),
    _entry(block_m=32.0),                      # not an int
    _entry(m=0),                               # non-positive key
    {k: v for k, v in _entry().items() if k != "block_m"},  # missing key
    {k: v for k, v in _entry().items() if k != "tr"},       # missing key
])
def test_bad_table_rejected_eagerly(bad):
    with pytest.raises(ValueError):
        ttil.set_tuned_table(_table(bad))


def test_lookup_exact_and_nearest():
    ttil.set_tuned_table(_table(_entry(m=512, block_m=16, tr=1),
                                _entry(m=4096, block_m=64, tr=4)))
    assert ttil.lookup_tuned("fupdate", 512, 16, "f32",
                             "cuda").source == "table-exact"
    near = ttil.lookup_tuned("fupdate", 700, 16, "f32", "cuda")
    assert near.source == "table-nearest" and near.block_m == 16
    # beyond the log-distance cap: both entries too far -> None
    assert ttil.lookup_tuned("fupdate", 512, 512, "f32", "cuda") is None
    # other precision / backend / family never match
    assert ttil.lookup_tuned("fupdate", 512, 16, "f16", "cuda") is None
    assert ttil.lookup_tuned("fupdate", 512, 16, "f32", "cpu") is None
    assert ttil.lookup_tuned("gram", 512, 16, "f32", "cuda") is None


def test_lookup_tie_prefers_larger_m():
    # m=1024 is log-equidistant from 512 and 2048
    ttil.set_tuned_table(_table(_entry(m=512, block_m=16, tr=1),
                                _entry(m=2048, block_m=64, tr=4)))
    assert ttil.lookup_tuned("fupdate", 1024, 16, "f32",
                             "cuda").block_m == 64


def test_lookup_skips_rows_of_another_fupdate_class():
    """A wide-class row (BN = 64) never steers a hot-loop launch (S <= 32)
    at its key: the nearest narrow-class row or the default does."""
    wide = _entry(m=2048, d=128, block_m=16, block_n=64, block_k=8, tr=4,
                  tc=8, depth=2)
    ttil.set_tuned_table(_table(wide))
    assert ttil.lookup_tuned("fupdate", 2048, 128, "f32", "cuda",
                             n=2048).block_m == 16
    assert ttil.lookup_tuned("fupdate", 2048, 128, "f32", "cuda",
                             n=32) is None
    assert ttil.resolve_tiles("fupdate", m=2048, d=128, n=16,
                              precision="f32", backend="cuda") \
        == ttil.DEFAULT_CONFIGS["fupdate"]
    narrow = _entry(m=8192, d=128, block_m=16, tr=1)
    ttil.set_tuned_table(_table(wide, narrow))
    hit = ttil.lookup_tuned("fupdate", 2048, 128, "f32", "cuda", n=32)
    assert hit.block_m == 16 and hit.source == "table-nearest"


def test_table_rows_outside_the_launch_class_are_never_chosen():
    """A row whose entry lies outside the launch's class is skipped by
    the lookup, even at the launch's exact key: a wide fupdate row for a
    hot-loop launch, a narrow one for the init pass, and a gram row of
    the other kind of kernel (which validation refuses outright)."""
    narrow_pipe = _entry(m=2048, d=128, block_m=16, tr=1, depth=4)
    ttil.set_tuned_table(_table(narrow_pipe))
    assert ttil.lookup_tuned("fupdate", 2048, 128, "f32", "cuda",
                             n=2048) is None
    assert ttil.resolve_tiles("fupdate", m=2048, d=128, n=2048,
                              precision="f32", backend="cuda") \
        == ttil.FUPDATE_WIDE_DEFAULT
    assert ttil.lookup_tuned("fupdate", 2048, 128, "f32", "cuda",
                             n=32).entry == (16, 32, 32, 1, 2, 4)
    simt_row = _entry(family="gram", m=8192, d=128, precision="bf16",
                      block_m=128, block_n=128, block_k=8, tr=8, tc=8,
                      depth=2)
    with pytest.raises(ValueError, match="class"):
        ttil.set_tuned_table(_table(simt_row))
    for precision in ("bf16", "f16"):
        allowed = {c.entry for c in ttil.menu("gram", precision=precision)}
        assert ttil.nearest_entry([simt_row], "gram", 8192, 128, "bf16",
                                  "cuda", allowed) is None
    assert ttil.nearest_entry([simt_row], "gram", 8192, 128, "bf16",
                              "cuda")[1] == 0.0     # the key itself fits


# The same synthetic keys, in each package's own valid form.
_KEYS = [(m, d) for m in (256, 512, 1024, 4096, 8192) for d in (16, 64, 128)]
_QUERIES = [(m, d) for m in (100, 300, 512, 700, 1024, 1500, 2048, 3000,
                             6000, 8192, 20000, 70000)
            for d in (8, 16, 24, 64, 100, 128, 300, 700)]


def test_lookup_picks_the_entry_the_jax_package_picks():
    j_entries = [dict(family="fupdate", m=m, d=d, precision="f32",
                      backend="interpret", block_m=128 * (i + 1),
                      block_n=None, block_k=128, depth=2)
                 for i, (m, d) in enumerate(_KEYS)]
    jtil.set_tuned_table(_table(*j_entries))
    t_entries = [_entry(m=m, d=d, backend="interpret")
                 for (m, d) in _KEYS]
    ttil.set_tuned_table(_table(*t_entries))
    picked = 0
    for m, d in _QUERIES:
        j = jtil.lookup_tuned("fupdate", m, d, "f32", "interpret")
        t = ttil.nearest_entry(t_entries, "fupdate", m, d, "f32",
                               "interpret")
        tl = ttil.lookup_tuned("fupdate", m, d, "f32", "interpret")
        if j is None:
            assert t is None and tl is None, (m, d)
            continue
        picked += 1
        assert _KEYS[j.block_m // 128 - 1] == (t[0]["m"], t[0]["d"]), (m, d)
        assert tl.source == j.source, (m, d)
    assert 0 < picked < len(_QUERIES)


# ---------------------------------------------------------------------------
# resolution precedence
# ---------------------------------------------------------------------------

def test_explicit_kwargs_beat_table():
    ttil.set_tuned_table(_table(_entry(block_m=64, tr=4, depth=4)))
    cfg = ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                             backend="cuda", block_m=32)
    # any explicit kwarg opts out of the table entirely: the rest come
    # from the default (BN 32, BK 32), not the table; the one entry at
    # BM 32 is taken, though its tile and depth are not the default's
    assert cfg == ttil.TileConfig(32, 32, 32, 2, 2, 4, "explicit")
    with pytest.raises(ValueError, match="menu"):
        ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                           backend="cuda", block_m=100)
    with pytest.raises(ValueError, match="menu"):      # BN of another class
        ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                           backend="cuda", block_n=64)
    cfg = ttil.resolve_tiles("gram", m=512, d=16, precision="f32",
                             backend="cuda", block_m=128, block_n=128,
                             block_k=8)
    assert cfg.entry == (128, 128, 8, 8, 8, 2) and cfg.source == "explicit"
    cfg = ttil.resolve_tiles("gram", m=512, d=16, precision="bf16",
                             backend="cuda", block_n=128)
    assert cfg.entry == (128, 128, 64, 2, 32, 4)     # the first that fits
    with pytest.raises(ValueError, match="bf16 rows"):
        ttil.resolve_tiles("gram", m=512, d=16, precision="bf16",
                           backend="cuda", block_k=32)


def test_env_escape_hatch_beats_table(monkeypatch):
    ttil.set_tuned_table(_table(_entry(block_m=64, tr=4, depth=4)))
    monkeypatch.setenv("REPRO_NO_AUTOTUNE", "1")
    cfg = ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                             backend="cuda")
    assert cfg == ttil.DEFAULT_CONFIGS["fupdate"]
    # explicit kwargs still work under the hatch
    cfg = ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                             backend="cuda", block_m=16)
    assert cfg.block_m == 16 and cfg.source == "explicit"


def test_table_then_default():
    ttil.set_tuned_table(_table(_entry(block_m=64, tr=4, depth=4)))
    hit = ttil.resolve_tiles("fupdate", m=512, d=16, n=16, precision="f32",
                             backend="cuda")
    assert hit.entry == (64, 32, 32, 4, 2, 4) and hit.source == "table-exact"
    miss = ttil.resolve_tiles("fupdate", m=512, d=16, n=16,
                              precision="f32", backend="cpu")
    assert miss == ttil.DEFAULT_CONFIGS["fupdate"]


def test_set_tuned_table_steers_the_next_call():
    """No trace: a new table steers the next resolution of a shape that
    was resolved before (the JAX package keeps a traced shape's)."""
    kw = dict(m=600, d=20, n=16, precision="f32", backend="cuda")
    ttil.set_tuned_table(_table(_entry(m=600, d=20, block_m=16, tr=1)))
    assert ttil.resolve_tiles("fupdate", **kw).block_m == 16
    ttil.set_tuned_table(_table(_entry(m=600, d=20, block_m=64, tr=4,
                                       depth=4)))
    assert ttil.resolve_tiles("fupdate", **kw).block_m == 64


@pytest.mark.parametrize("family,n,precision,entry", [
    ("gram", None, "f32", (64, 64, 32, 4, 4, 1)),
    ("gram", None, "bf16", (128, 256, 64, 2, 64, 3)),   # wgmma
    ("gram", None, "f16", (128, 256, 64, 2, 64, 3)),
    ("fupdate", 16, "f32", (64, 32, 32, 4, 2, 1)),   # the hot loop at P = 8
    ("fupdate", 32, "f32", (64, 32, 32, 4, 2, 1)),   # ... and at P = 16
    ("fupdate", 33, "f32", (64, 64, 8, 4, 8, 2)),   # the SIMT split tile
    ("fupdate", 2048, "f32", (64, 64, 8, 4, 8, 2)),  # the init pass
    ("decision", 4096, "f32", (128, 64, 8, 8, 8, 2)),   # SIMT
    ("decision", 4096, "bf16", (128, 32, 64, 2, 8, 4)),  # wgmma
    ("decision", 4096, "f16", (128, 32, 64, 2, 8, 4)),
    ("fupdate", 16, "bf16", (64, 32, 32, 4, 2, 1)),   # narrow: any type
    ("fupdate", 128, "bf16", (128, 32, 64, 2, 8, 4)),  # the wgmma split
    ("fupdate", 2048, "f16", (128, 32, 64, 2, 8, 4)),
])
def test_empty_table_gives_the_fixed_launches(family, n, precision, entry):
    """With no table row every launch is its class's default: the one its
    source fixed before the table (fupdate's narrow class: <64, 32, 4, 2>
    up to S = 32, any type; f32 gram <64, 64, 4, 4>), and for 16-bit gram
    the wgmma default; the split classes' first entries (decision's, and
    fupdate's above S = 32: the f32 SIMT tile, the 16-bit wgmma
    kernel)."""
    ttil.set_tuned_table({"entries": []})
    cfg = ttil.resolve_tiles(family, m=8192, d=128, n=n, precision=precision,
                             backend="cuda")
    assert cfg.entry == entry and cfg.source == "default"
    assert cfg == ttil.default_config(family, n, precision)


def test_backend_name_is_the_device_type():
    assert ttil.backend_name(torch.zeros(1)) == "cpu"
    assert ttil.backend_name("cuda") == "cuda"
    assert ttil.backend_name(torch.device("cuda", 0)) == "cuda"


def test_wrappers_check_explicit_tiles_on_the_cpu():
    kern = tkf.rbf(0.5)
    x = torch.randn(40, 6, generator=torch.Generator().manual_seed(0))
    args = (x, x[:8], torch.full((8,), 0.1), torch.zeros(40), kern)
    base = tfup.fupdate(*args)
    assert torch.equal(base, tfup.fupdate(*args, tm=16))
    with pytest.raises(ValueError, match="menu"):
        tfup.fupdate(*args, tm=100)
    from repro_torch.kernels.decision import ops as tdec
    with pytest.raises(ValueError, match="menu"):
        tdec.decision(x, x, torch.ones(40), 0.1, 0.9, kern, tn=512)


# ---------------------------------------------------------------------------
# the autotuner's models
# ---------------------------------------------------------------------------

def test_cost_model_flops_equal_the_jax_packages():
    jdefault = {"gram": (256, 256, 512), "fupdate": (512, None, 512),
                "decision": (256, 512, None)}
    for jc in J_FULL_CELLS:
        tc = tat.Cell(jc.family, jc.m, jc.n, jc.d)
        dflt = ttil.default_config(jc.family, jc.n)
        for precision in ("f32", "bf16"):
            bm, bn, bk = jdefault[jc.family]
            jf, _ = j_cost_model(jc, block_m=bm, block_n=bn, block_k=bk,
                                 precision=precision)
            tf, tb = tat.cost_model(tc, block_m=dflt.block_m,
                                    block_n=dflt.block_n,
                                    block_k=dflt.block_k,
                                    precision=precision)
            assert tf == jf, jc
            assert tb > 0


def test_cost_model_counts_the_streamed_bytes():
    # gram 8192^2 x 128, f32, 64 x 64 tiles: x and y each read once per
    # tile of the other, the output and the norms once per tile.
    c = tat.Cell("gram", 8192, 8192, 128)
    flops, hbm = tat.cost_model(c, block_m=64, block_n=64, precision="f32")
    assert flops == 2.0 * 8192 ** 2 * 128
    assert hbm == 2 * 8192 * 128 * 4 * 128 + 8192 ** 2 * 4 \
        + 2 * 8192 * 128 * 4
    _, hbm16 = tat.cost_model(c, block_m=64, block_n=64, precision="bf16")
    assert hbm16 < hbm
    # fupdate: x once, xsel/delta/norms per CTA, ragged tiles unpadded
    f = tat.Cell("fupdate", 1000, 20, 33)
    _, fb = tat.cost_model(f, block_m=64, block_n=32, precision="f32")
    assert fb == 1000 * 33 * 4 + 20 * 33 * 4 * 16 + 12 * 1000 + 16 * 160


def test_cost_model_counts_the_split_decision_bytes():
    # f32 SIMT at 4096 queries x 4096 support, BM = 128, SW = 64: the
    # support rows once per query tile, the queries once per split, the
    # partials written and read once.
    c = tat.Cell("decision", 4096, 4096, 128)
    flops, hbm = tat.cost_model(c, block_m=128, block_n=64, block_k=8,
                                precision="f32")
    assert flops == 2.0 * 4096 * 4096 * 128 + 2.0 * 4096 * 4096
    gq, splits = 32, 64
    assert hbm == (4096 * 128 * 4 * splits + 4096 * 128 * 4 * gq
                   + 2 * 4096 * 4 * gq + 4096 * 4 * splits
                   + 2 * splits * 4096 * 4 + 4096 * 4)
    # wgmma, SW = 32: a CTA reads its query tile once for its run of
    # splits, so the queries are read far fewer than 128 times.
    _, hbm16 = tat.cost_model(c, block_m=128, block_n=32, block_k=64,
                              precision="bf16")
    wg = ttil.TileConfig(128, 32, 64, 2, 8, 4)
    qtiles, groups = ttil.decision_grid(
        4096, 4096, wg, tat.H100_SMS, tat.ctas_per_sm("decision", wg,
                                                      "bf16"))
    assert qtiles == 32 and 1 < groups < 128
    assert hbm16 == (4096 * 128 * 2 * groups + 4096 * 128 * 2 * qtiles
                     + 2 * 4096 * 4 * qtiles + 4096 * 4 * groups
                     + 2 * 128 * 4096 * 4 + 4096 * 4)


def test_classify_on_the_h100_roofline():
    # gram 8192^2 x 128 in f32: 64 x 64 tiles re-read each operand 128
    # times (1.3 GB requested, above the 0.256 ms of operations); 128 x 128
    # tiles halve that and the operations bound it.
    c = tat.Cell("gram", 8192, 8192, 128)
    fl, f32b = tat.cost_model(c, block_m=64, block_n=64, precision="f32")
    assert tat.classify(fl, f32b, "f32") == "memory"
    fl, f32b = tat.cost_model(c, block_m=128, block_n=128, precision="f32")
    assert tat.classify(fl, f32b, "f32") == "compute"
    fl, b16b = tat.cost_model(c, block_m=64, block_n=64, precision="bf16")
    assert tat.classify(fl, b16b, "bf16") == "memory"
    c = tat.Cell("fupdate", 8192, 32, 128)
    fl, fb = tat.cost_model(c, block_m=64, block_n=32, precision="f32")
    assert tat.classify(fl, fb, "f32") == "memory"


def test_candidates_reject_an_infeasible_config(monkeypatch):
    cell = tat.Cell("gram", 512, 512, 16)
    dflt = ttil.DEFAULT_CONFIGS["gram"]
    too_much_smem = ttil.TileConfig(256, 256, 32, 8, 8)
    too_many_threads = ttil.TileConfig(128, 128, 32, 1, 1)
    partial_warp = ttil.TileConfig(8, 8, 32, 2, 2)
    too_many_regs = ttil.TileConfig(128, 128, 32, 16, 16)
    monkeypatch.setattr(tat, "menu", lambda family, n, precision: (
        dflt, too_much_smem, too_many_threads, partial_warp, too_many_regs))
    got = tat.candidates(cell, precision="f32")
    assert got == [dict(block_m=64, block_n=64, block_k=32, tr=4, tc=4,
                        depth=1)]
    # a row's threads must sit in one warp for the row-sum kernels only
    wide_rows = ttil.TileConfig(16, 128, 32, 2, 2)
    assert tat.feasible("gram", wide_rows)
    assert not tat.feasible("fupdate", wide_rows)


def test_register_estimate_covers_ptxas_and_the_launch_bounds():
    """The model is at or above the counts ptxas gave the new kernels
    on an H100 (the largest over their types and builds), and never above
    what
    ``__launch_bounds__`` leaves a thread of a full CTA."""
    ptxas = {("fupdate", (16, 32, 32, 1, 2, 4)): 118,
             ("fupdate", (64, 32, 32, 4, 2, 4)): 80,
             ("fupdate", (32, 32, 32, 2, 2, 4)): 64,
             ("gram", (128, 128, 8, 8, 8, 2)): 122,
             ("gram", (128, 256, 64, 2, 64, 3)): 168,
             ("gram", (128, 128, 64, 2, 32, 4)): 114,
             ("decision", (128, 64, 8, 8, 8, 2)): 155,
             ("decision", (16, 64, 8, 4, 8, 2)): 96,
             ("decision", (128, 32, 64, 2, 8, 4)): 51,
             ("decision", (128, 32, 64, 2, 16, 4)): 63,
             ("decision", (128, 32, 64, 2, 32, 4)): 95}
    for (family, entry), used in ptxas.items():
        assert tat.register_estimate(family, ttil.config_of(entry)) >= used
    for family, entries in ttil.MENUS.items():
        for entry in entries:
            cfg = ttil.config_of(entry)
            regs = tat.register_estimate(family, cfg)
            assert regs * tat.threads(family, cfg) <= tat.REGS_PER_SM
    wide = ttil.config_of((64, 32, 32, 2, 2, 4))     # 512 threads
    assert tat.register_estimate("fupdate", wide) == 128


def test_feasible_counts_dynamic_shared_memory():
    """The pipelined and wgmma rings are dynamic shared memory: they may
    pass 48 KiB (the launchers opt in) but not the SM's 227 KiB, and a
    pipelined fupdate ring's size follows the rows' type."""
    wg = ttil.GRAM_WGMMA_DEFAULT                  # 3 x 48 KiB stages
    assert tat.smem_bytes("gram", wg) == (
        0, 3 * 384 * 64 * 2 + 4 * 16384 + 2 * 256 * 4 + 1024 + 48)
    assert tat.feasible("gram", wg, "bf16")
    assert tat.threads("gram", wg) == 384         # + the producer
    deep = ttil.TileConfig(128, 256, 64, 2, 64, 4)  # 228 KiB with the rest
    assert not tat.feasible("gram", deep, "bf16")
    pipe = ttil.TileConfig(64, 32, 32, 4, 2, 4)
    static, dynamic = tat.smem_bytes("fupdate", pipe, "f32")
    assert static == 0 and dynamic == 4 * 96 * 144 > tat.SMEM_STATIC_BYTES
    assert tat.feasible("fupdate", pipe, "f32")
    big = ttil.TileConfig(128, 32, 32, 8, 2, 16)
    assert tat.smem_bytes("fupdate", big, "bf16")[1] == 16 * 160 * 80
    assert tat.feasible("fupdate", big, "bf16")
    assert not tat.feasible("fupdate", big, "f32")   # 368,640 bytes
    # the tile's one stage stays static, and capped at 48 KiB
    tile = ttil.TileConfig(256, 256, 32, 8, 8)
    assert tat.smem_bytes("gram", tile)[0] > tat.SMEM_STATIC_BYTES
    assert not tat.feasible("gram", tile)


def test_candidates_are_the_launch_class_and_all_feasible():
    for cell in tat.FULL_CELLS:
        for precision in ("f32", "bf16"):
            got = tat.candidates(cell, precision=precision)
            assert [ttil.row_config(c).entry for c in got] \
                == [c.entry for c in ttil.menu(cell.family, cell.n,
                                               precision)]
    assert set(tat.QUICK_CELLS) < set(tat.FULL_CELLS)
    assert set(tat.MAIN_CELLS) < set(tat.FULL_CELLS)
    assert [(c.family, c.m, c.n, c.d) for c in tat.QUICK_CELLS] \
        == [("gram", 512, 512, 16), ("fupdate", 512, 16, 16),
            ("decision", 512, 128, 16)]


def test_sweep_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        tat.sweep(tat.QUICK_CELLS[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tat.main(["--quick", "--json", "/dev/null"])


def test_winner_rows_make_valid_entries(tmp_path):
    win = dict(name="fupdate_m8192_n32_d128_best", family="fupdate",
               m=8192, n=32, d=128, precision="f32", block_m=16,
               block_n=32, block_k=32, tr=1, tc=2, depth=1, bound="memory",
               flops=1.0, hbm_bytes=2.0, best_s=5e-6)
    entries = tat.winners_to_entries({"backend": "cuda", "winners": [win]})
    assert set(entries[0]) == set(ttil._REQUIRED_ENTRY_KEYS) | {"bound",
                                                               "best_s"}
    tat.write_table(entries, tmp_path / "t.json")
    ttil.set_tuned_table(str(tmp_path / "t.json"))
    assert ttil.resolve_tiles("fupdate", m=8192, d=128, n=32,
                              precision="f32", backend="cuda").entry \
        == (16, 32, 32, 1, 2, 1)


def test_ptxas_register_lines_parse():
    lines = [
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "11gram_kernelIfLi128ELi128ELi32ELi4ELi8ELi1EEEvPKT_S5_PKfS7_PfiiiNS"
        "_12KernelParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5repro",
        "ptxas info    : Used 72 registers, used 1 barriers, 24832 bytes smem",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "14fupdate_kernelI13__nv_bfloat16Li64ELi32ELi32ELi4ELi2ELi1EEEvPKT_'"
        " for 'sm_90a'",
        "ptxas info    : Used 38 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "15decision_kernelI6__halfLi16ELi64ELi32ELi1ELi4ELi1EEEvPKT_' for "
        "'sm_90a'",
        "ptxas info    : Used 30 registers",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "17gram_wgmma_kernelI13__nv_bfloat16Li128ELi256ELi64ELi2ELi64ELi4EE"
        "EvK14CUtensorMap_stS5_PKfS7_PfiiiNS_12KernelParamsE' for 'sm_90a'",
        "ptxas info    : Used 168 registers",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "19fupdate_pipe_kernelIfLi32ELi32ELi32ELi2ELi2ELi4EEEvPKT_' for "
        "'sm_90a'",
        "ptxas info    : Used 56 registers",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "16gram_simt_kernelIfLi128ELi128ELi8ELi8ELi8ELi2EEEvPKfS4_' for "
        "'sm_90a'",
        "ptxas info    : Used 128 registers",
    ]
    assert tat.ptxas_registers(lines) == {
        ("gram", "f32", (128, 128, 32, 4, 8, 1)): 72,
        ("fupdate", "bf16", (64, 32, 32, 4, 2, 1)): 38,
        ("decision", "f16", (16, 64, 32, 1, 4, 1)): 30,
        ("gram", "bf16", (128, 256, 64, 2, 64, 4)): 168,
        ("fupdate", "f32", (32, 32, 32, 2, 2, 4)): 56,
        ("gram", "f32", (128, 128, 8, 8, 8, 2)): 128}


def test_ptxas_lines_of_the_split_kernels_take_the_source_family():
    """split_rows.cuh's kernels are named for no family: their lines count
    for the source they were built in, and not at all without one; the
    reduction (no tile) is no menu entry."""
    lines = [
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "17split_simt_kernelIfLi64ELi64ELi8ELi4ELi8ELi2EEEvPKfS4_' for "
        "'sm_90a'",
        "ptxas info    : Used 75 registers, used 1 barriers, 8704 bytes smem",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "18split_wgmma_kernelI13__nv_bfloat16Li128ELi32ELi64ELi2ELi16ELi3E"
        "Lb1EEEv14CUtensorMap_stS2_PKfS4_S4_Pfiii' for 'sm_90a'",
        "ptxas info    : Used 66 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_1"
        "19split_reduce_kernelINS0_6AddToFEEEvPKfiiT_' for 'sm_90a'",
        "ptxas info    : Used 16 registers, used 1 barriers",
    ]
    assert tat.ptxas_registers(lines, "fupdate") == {
        ("fupdate", "f32", (64, 64, 8, 4, 8, 2)): 75,
        ("fupdate", "bf16", (128, 32, 64, 2, 16, 3)): 66}
    assert tat.ptxas_registers(lines) == {}
    # decision's wide streamed entry: split_wgmma_kernel_cluster
    wide = ["ptxas info    : Compiling entry function '_ZN5repro44_GLOBAL__N"
            "__8c5a0d6c_11_decision_cu_004caa9626split_wgmma_kernel_clusterI"
            "13__nv_bfloat16Li128ELi32ELi64ELi2ELi64ELi4EEEv14CUtensorMap_st"
            "S3_PKfS5_S5_PfiiiNS_12KernelParamsEi' for 'sm_90a'",
            "ptxas info    : Used 168 registers, used 0 barriers"]
    assert tat.ptxas_registers(wide, "decision") == {
        ("decision", "bf16", ttil.STREAMED_WIDE): 168}


# ---------------------------------------------------------------------------
# the committed table
# ---------------------------------------------------------------------------

def test_committed_table_is_valid_cuda_rows_on_the_menus():
    assert ttil.TUNED_TABLE_PATH.exists(), \
        "src/repro_torch/kernels/tuned_configs.json must be committed"
    with open(ttil.TUNED_TABLE_PATH) as fh:
        doc = json.load(fh)
    ttil.set_tuned_table(doc)   # eager validation of every entry
    assert doc["entries"]
    for e in doc["entries"]:
        assert e["backend"] == "cuda"
        cfg = ttil.row_config(e)
        assert cfg.entry in ttil.MENUS[e["family"]]
        assert e["precision"] in ttil.precisions_of(e["family"], cfg)
        assert e["best_s"] > 0 and e["bound"] in ("memory", "compute")
    keys = {(e["family"], e["m"], e["d"], e["precision"])
            for e in doc["entries"]}
    for c in tat.FULL_CELLS:
        for precision in ("f32", "bf16"):
            assert (c.family, c.m, c.d, precision) in keys, c
    # the fit's hot loop at m = 8192, d = 128 launches from an exact row
    ttil.set_tuned_table(None)
    for precision in ("f32", "bf16"):
        cfg = ttil.resolve_tiles("fupdate", m=8192, d=128, n=32,
                                 precision=precision, backend="cuda")
        assert cfg.source == "table-exact"


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_terms_use_the_h100_peaks():
    t = roofline.terms(67e12, 3.35e12, 0.0, 1, "f32")
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    t = roofline.terms(989e12, 0.0, 450e9, 2, "bf16")
    assert t.compute_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant in ("compute", "collective")
    # gram 8192^2 x 128: 0.256 ms of f32 operations, 0.080 ms of output
    g = roofline.terms(2.0 * 8192 ** 2 * 128, 8192 ** 2 * 4.0)
    assert g.dominant == "compute"
    assert g.step_time_s == pytest.approx(2.5645e-4, rel=1e-3)
    assert g.memory_s == pytest.approx(8.013e-5, rel=1e-3)
    assert set(t.to_dict()) >= {"compute_s", "memory_s", "dominant"}
    with pytest.raises(ValueError):
        roofline.terms(1.0, 1.0, precision="tf32")

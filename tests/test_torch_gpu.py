"""The port's CUDA kernels held against their plain versions, on the card
(and every menu entry against its default, bitwise).

    python -m pytest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, so every worker collects the same tests). The file
imports nothing of JAX: the machine with the card has no JAX. Kernel and
plain version see the same operands, so they differ by the f32 summation
order only and are compared at the f32 tolerance of ``TOLERANCES``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core.kernel_fn as tkf
from repro_torch.api import resolve_device
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec
from repro_torch.data import make_toy
from repro_torch.kernels import precision as tprec
from repro_torch.kernels.decision import ops as tdec
from repro_torch.kernels.decision.ref import decision_plain
from repro_torch.kernels.fupdate import ops as tfup
from repro_torch.kernels.fupdate.ref import fupdate_plain
from repro_torch.kernels.gram import ops as tgram
from repro_torch.kernels.gram.ref import gram_plain
from repro_torch.kernels import tiling as ttil
from repro_torch.serve.model_cache import ModelCache, pack_model

pytestmark = pytest.mark.gpu

KERNELS = [("linear", 1.0, 0.0, 3), ("rbf", 0.35, 0.0, 3),
           ("poly", 0.2, 1.0, 2), ("poly", 0.2, 1.0, 3)]
KIDS = ["linear", "rbf", "poly2", "poly3"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # and TF32 off


def _kern(k):
    name, g, c0, deg = k
    return tkf.KernelFn(name=name, gamma=g, coef0=c0, degree=deg)


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _close(out, ref):
    ref = ref.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref,
                               **tprec.truth_tolerance("f32", ref))


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("m,d,s", [(1000, 37, 16), (333, 130, 33),
                                   (2048, 128, 2048)])
def test_fupdate_kernel_matches_plain(cuda, k, precision, m, d, s):
    tk = _kern(k)
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((m, d)) / np.sqrt(d), cuda).to(
        tprec.tile_dtype(precision))
    xs = x[:s].contiguous()
    delta = _t(rng.standard_normal(s) * 0.1, cuda)
    f = _t(rng.standard_normal(m), cuda)
    xn, seln = tfup.row_norms(x), tfup.row_norms(xs)
    n0 = tfup.FUPDATE.launches
    out = tfup.fupdate(x, xs, delta, f, tk, precision=precision, xn=xn)
    torch.cuda.synchronize()
    assert tfup.FUPDATE.launches == n0 + 1
    plain = fupdate_plain(x, xs, delta, f, xn, seln, kind=k[0], gamma=k[1],
                          coef0=k[2], degree=k[3])
    _close(out, plain)


@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
def test_fupdate_zero_rows_add_nothing(cuda, k):
    """Zero rows with zero deltas appended to the selected block add
    exactly nothing within its class: each thread's partial sum (and, in
    the wide class, each further split's partial) only gains +0 terms.
    The narrow class (S <= 32) and the wide one sum in other orders, so
    the block stays on its side of S = 32."""
    tk = _kern(k)
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((96, 17)), cuda)
    f = _t(rng.standard_normal(96), cuda)
    for s, extra in ((5, 27), (40, 128)):
        dl = _t(rng.standard_normal(s) * 0.1, cuda)
        out = tfup.fupdate(x, x[:s], dl, f, tk)
        xs = torch.cat([x[:s], torch.zeros((extra, 17), device=cuda)])
        dp = torch.cat([dl, torch.zeros(extra, device=cuda)])
        assert torch.equal(out, tfup.fupdate(x, xs, dp, f, tk))


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("nq", [64, 100, 4096])
def test_decision_kernel_matches_plain(cuda, k, precision, nq):
    tk = _kern(k)
    rng = np.random.default_rng(9)
    T = rng.standard_normal((1500, 128)) / np.sqrt(128)
    model = OCSSVMModel(gamma=_t(rng.standard_normal(1500) * 0.05, cuda),
                        rho1=_t(0.2, cuda), rho2=_t(0.8, cuda),
                        X=_t(T, cuda), spec=SlabSpec(kernel=tk))
    sm = pack_model(model, precision=precision, sv_threshold=0.0)
    q = _t(rng.standard_normal((nq, 128)) / np.sqrt(128), cuda).to(
        tprec.tile_dtype(precision))
    n0 = tdec.DECISION.launches
    out = tdec.decision_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms, 0.2,
                               0.8, tk, tm=nq, tn=sm.tn, precision=precision)
    torch.cuda.synchronize()
    assert tdec.DECISION.launches == n0 + 1
    plain = decision_plain(q, sm.t_pad, sm.gamma_pad.reshape(-1),
                           tfup.row_norms(q), sm.t_norms.reshape(-1), 0.2,
                           0.8, kind=k[0], gamma=k[1], coef0=k[2],
                           degree=k[3])
    _close(out, plain)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fit_and_serve_on_the_card_match_the_cpu(cuda, precision):
    """The fused provider on the card against the plain provider on the
    CPU, end to end, within the solver floor of the parity tests."""
    X, _ = make_toy(3, 600, d=16)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 16))
    kw = dict(strategy="pallas", P=16, tol=1e-3, precision=precision)
    n0 = tfup.FUPDATE.launches
    on_card = repro_torch.fit(X, spec, **kw)
    assert tfup.FUPDATE.launches - n0 >= int(on_card.iters) > 0
    on_cpu = repro_torch.fit(X, spec, device="cpu", **kw)
    assert bool(on_card.converged) and bool(on_cpu.converged)
    rho = [float(on_card.model.rho1), float(on_card.model.rho2)]
    np.testing.assert_allclose(rho, [float(on_cpu.model.rho1),
                                     float(on_cpu.model.rho2)], atol=5e-3)
    sm = repro_torch.serve(X, spec, cache=ModelCache(), offsets="quantile",
                           **kw)
    q = make_toy(4, 65, d=16)[0]
    s = sm.score(q)
    ref = sm.model.decision_function(_t(q, cuda)).cpu().numpy()
    np.testing.assert_allclose(s, ref, **tprec.truth_tolerance("f32", ref))


# -- gram, the menus and the tuned table -------------------------------------

@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("m,n,d", [(130, 77, 129), (300, 257, 16)])
def test_gram_kernel_matches_plain(cuda, k, precision, m, n, d):
    tk = _kern(k)
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((m, d)) / np.sqrt(d), cuda)
    y = _t(rng.standard_normal((n, d)) / np.sqrt(d), cuda)
    n0 = tgram.GRAM.launches
    out = tgram.gram(x, y, tk, precision=precision)
    torch.cuda.synchronize()
    assert tgram.GRAM.launches == n0 + 1 and out.shape == (m, n)
    plain = gram_plain(x, y, kind=k[0], gamma=k[1], coef0=k[2], degree=k[3],
                       precision=precision)
    _close(out, plain)


def _menu_cases():
    """(family, S or None, menu index, precision) for every menu entry in
    each precision its class takes: fupdate's at an S of their class."""
    cases = []
    for family, entries in ttil.MENUS.items():
        for i, entry in enumerate(entries):
            kind = ttil.kernel_of(family, ttil.config_of(entry))
            s = None if family != "fupdate" else (
                20 if kind in ("tile", "pipe") else 77)
            for precision in ttil.precisions_of(family,
                                                ttil.config_of(entry)):
                cases.append((family, s, i, precision))
    return cases


@pytest.mark.parametrize("family,s,idx,precision", _menu_cases(),
                         ids=[f"{f}-{i}-{p}" for f, _, i, p in _menu_cases()])
def test_every_menu_entry_is_bitwise_the_default(cuda, family, s, idx,
                                                 precision):
    """Each menu entry, launched at a ragged shape, agrees with the plain
    version and is bitwise equal to its class's default entry."""
    cfg = ttil.config_of(ttil.MENUS[family][idx], "explicit")
    tk = _kern(KERNELS[1])
    rng = np.random.default_rng(11)
    a = _t(rng.standard_normal((203, 45)) / np.sqrt(45), cuda)
    if family == "gram":
        ops = tgram.prepare(a, a[:77], precision=precision)

        def run(c):
            return tgram.launch(*ops, tk, c)()
        plain = gram_plain(ops[0], ops[1], kind="rbf", gamma=tk.gamma,
                           precision=precision)
    elif family == "fupdate":
        ops = tfup.prepare(a, a[:s], _t(rng.standard_normal(s), cuda),
                           _t(rng.standard_normal(203), cuda),
                           precision=precision)

        def run(c):
            return tfup.launch(*ops, tk, c)()
        plain = fupdate_plain(*ops, kind="rbf", gamma=tk.gamma)
    else:
        ops = tdec.prepare(a[:77], a, _t(np.abs(rng.standard_normal(203)),
                                         cuda), precision=precision)

        def run(c):
            return tdec.launch(*ops, 0.2, 0.8, tk, c)()
        plain = decision_plain(*ops, 0.2, 0.8, kind="rbf", gamma=tk.gamma)
    assert cfg in ttil.menu(family, s, precision)
    out, base = run(cfg), run(ttil.default_config(family, s, precision))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), base.view(torch.int32))
    _close(out, plain)


def test_off_menu_launch_index_is_refused(cuda):
    x = _t(np.ones((40, 8)), cuda)
    ops = tgram.prepare(x, x)
    good = tgram.launch(*ops, _kern(KERNELS[0]))
    bad = dataclasses.replace(
        good, args=good.args[:-2] + (len(ttil.MENUS["gram"]),)
        + good.args[-1:])
    n0 = tgram.GRAM.launches
    with pytest.raises(RuntimeError, match="gram_launch failed"):
        bad()
    assert tgram.GRAM.launches == n0


def test_table_steers_the_fupdate_launch(cuda, monkeypatch):
    """A table row for the launch's key picks its entry; the output is
    bitwise that of the default launch."""
    rng = np.random.default_rng(12)
    x = _t(rng.standard_normal((700, 24)), cuda)
    args = (x, x[:16], _t(rng.standard_normal(16) * 0.1, cuda),
            _t(rng.standard_normal(700), cuda), _kern(KERNELS[1]))
    row = dict(family="fupdate", m=700, d=24, precision="f32",
               backend="cuda", block_m=16, block_n=32, block_k=32, tr=1,
               tc=2, depth=4)
    try:
        ttil.set_tuned_table({"entries": [row]})
        tuned = tfup.fupdate(*args)
        assert tfup.FUPDATE.last_config == ttil.TileConfig(
            16, 32, 32, 1, 2, 4, "table-exact")
        monkeypatch.setenv("REPRO_NO_AUTOTUNE", "1")
        base = tfup.fupdate(*args)
        assert tfup.FUPDATE.last_config == ttil.DEFAULT_CONFIGS["fupdate"]
    finally:
        ttil.set_tuned_table(None)
    assert torch.equal(tuned.view(torch.int32), base.view(torch.int32))


def test_sweep_times_a_cell_and_its_winners_make_a_table(cuda, tmp_path):
    from repro_torch.kernels import autotune as tat
    cells = (tat.Cell("gram", 256, 256, 8), tat.Cell("fupdate", 300, 16, 8))
    res = tat.sweep(cells, precisions=("f32",), repeats=1)
    assert res["backend"] == "cuda" and len(res["winners"]) == 2
    assert len(res["candidates"]) == sum(
        len(tat.candidates(c, precision="f32")) for c in cells)
    for row in res["candidates"]:
        assert row["time_s"] > 0 and row["bound"] in ("memory", "compute")
    tat.write_table(tat.winners_to_entries(res), tmp_path / "t.json")
    try:
        ttil.set_tuned_table(str(tmp_path / "t.json"))
        cfg = ttil.resolve_tiles("gram", m=256, d=8, precision="f32",
                                 backend="cuda")
        assert cfg.source == "table-exact"
    finally:
        ttil.set_tuned_table(None)


# -- the redesigned classes at the main path's and ragged shapes ---------------

def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("m,n,d", [(8192, 8192, 128), (130, 77, 129),
                                   (203, 77, 45), (8193, 300, 128)])
def test_gram_class_entries_match_plain_and_their_default(cuda, precision,
                                                         m, n, d):
    """Every entry of the precision's gram class (SIMT for f32, wgmma for
    bf16/f16) agrees with the plain version, rbf, and is bitwise the
    class's default; the wrapper's own launch is of that class."""
    rng = np.random.default_rng(13)
    x = _t(rng.standard_normal((m, d)) / np.sqrt(d), cuda)
    y = _t(rng.standard_normal((n, d)) / np.sqrt(d), cuda)
    tk = tkf.rbf(1.0 / d)
    ops = tgram.prepare(x, y, precision=precision)
    plain = gram_plain(x, y, kind="rbf", gamma=tk.gamma, precision=precision)
    base = tgram.launch(*ops, tk, ttil.default_config(
        "gram", precision=precision))()
    for cfg in ttil.menu("gram", precision=precision):
        out = tgram.launch(*ops, tk, cfg)()
        torch.cuda.synchronize()
        assert _bitwise(out, base), cfg
        del out
    _close(base, plain)
    tgram.gram(x, y, tk, precision=precision)
    kind = ttil.kernel_of("gram", tgram.GRAM.last_config)
    assert (kind == "wgmma") == (precision != "f32")


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_gram_empty_operands(cuda, precision):
    x = torch.ones((5, 16), device=cuda)
    n0 = tgram.GRAM.launches
    for a, b in ((x[:0], x), (x, x[:0]), (x[:0], x[:0])):
        out = tgram.gram(a, b, tkf.linear(), precision=precision)
        assert out.shape == (a.shape[0], b.shape[0])
        assert out.device.type == "cuda"
    assert tgram.GRAM.launches == n0


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("m,s,d", [(8192, 32, 128), (8192, 16, 128),
                                   (203, 20, 45), (130, 32, 129)])
def test_narrow_fupdate_entries_match_plain_and_their_default(
        cuda, precision, m, s, d):
    """Every entry of fupdate's narrow class, the pipelined ones among
    them, agrees with the plain version and is bitwise its default (PR
    12's tile): the sums keep their order."""
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((m, d)) / np.sqrt(d), cuda)
    tk = tkf.rbf(1.0 / d)
    ops = tfup.prepare(x, x[:s], _t(rng.standard_normal(s) * 0.1, cuda),
                       _t(rng.standard_normal(m), cuda), precision=precision)
    plain = fupdate_plain(*ops, kind="rbf", gamma=tk.gamma)
    base = tfup.launch(*ops, tk, ttil.default_config("fupdate", s))()
    pipes = 0
    for cfg in ttil.menu("fupdate", s):
        out = tfup.launch(*ops, tk, cfg)()
        torch.cuda.synchronize()
        assert _bitwise(out, base), cfg
        pipes += ttil.kernel_of("fupdate", cfg) == "pipe"
    assert pipes > 0
    _close(base, plain)


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_fupdate_empty_rows(cuda, precision):
    x = torch.ones((4, 16), device=cuda)
    n0 = tfup.FUPDATE.launches
    out = tfup.fupdate(x[:0], x, torch.zeros(4, device=cuda),
                       torch.zeros(0, device=cuda), tkf.rbf(0.5),
                       precision=precision)
    assert out.shape == (0,) and tfup.FUPDATE.launches == n0


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("m,s,d", [(8192, 128, 128), (8192, 433, 128),
                                   (2048, 2048, 128), (333, 33, 130),
                                   (130, 77, 129)])
def test_wide_fupdate_entries_match_plain_and_their_default(
        cuda, precision, m, s, d):
    """Every entry of fupdate's wide class of the precision (the SIMT split
    tile for f32, the wgmma split kernel for bf16/f16, its streamed entry
    too) agrees with the plain version, rbf and linear, and is bitwise
    the class's default; the wrapper's own launch is of that class."""
    rng = np.random.default_rng(19)
    x = _t(rng.standard_normal((max(m, s), d)) / np.sqrt(d), cuda)
    delta = _t(rng.standard_normal(s) * 0.05, cuda)
    f = _t(rng.standard_normal(m), cuda)
    for tk in (tkf.rbf(1.0 / d), tkf.linear()):
        ops = tfup.prepare(x[:m], x[:s], delta, f, precision=precision)
        plain = fupdate_plain(*ops, kind=tk.name, gamma=tk.gamma)
        base = tfup.launch(*ops, tk, ttil.default_config(
            "fupdate", s, precision))()
        cls = ttil.menu("fupdate", s, precision)
        for cfg in cls:
            out = tfup.launch(*ops, tk, cfg)()
            torch.cuda.synchronize()
            assert _bitwise(out, base), cfg
        _close(base, plain)
        n0 = tfup.FUPDATE.launches
        wrapped = tfup.fupdate(x[:m], x[:s], delta, f, tk,
                               precision=precision)
        assert tfup.FUPDATE.launches == n0 + 1
        assert tfup.FUPDATE.last_config.entry in {c.entry for c in cls}
        assert _bitwise(wrapped, base)


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_wide_fupdate_empty_block_and_rows(cuda, precision):
    """A wide launch with no selected row (no split) writes f; one with
    no training row writes nothing and launches nothing of size 0."""
    x = torch.ones((300, 64), device=cuda)
    f = torch.randn(300, device=cuda)
    cfg = ttil.default_config("fupdate", 33, precision)
    ops = tfup.prepare(x, x[:0], torch.zeros(0, device=cuda), f,
                       precision=precision)
    launch = tfup.launch(*ops, tkf.rbf(0.5), cfg)
    assert launch.scratch.shape == (0, 300)
    assert torch.equal(launch(), f)
    ops = tfup.prepare(x[:0], x[:50], torch.ones(50, device=cuda),
                       f[:0], precision=precision)
    out = tfup.launch(*ops, tkf.rbf(0.5), cfg)()
    torch.cuda.synchronize()
    assert out.shape == (0,)


# -- decision: the split design at the serving buckets and ragged shapes ------

def _packed_model(cuda, precision, n_sv=1500, d=128, seed=15, zero=False):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((n_sv, d)) / np.sqrt(d)
    g = np.zeros(n_sv) if zero else np.abs(rng.standard_normal(n_sv)) * 0.05
    model = OCSSVMModel(gamma=_t(g, cuda), rho1=_t(0.2, cuda),
                        rho2=_t(0.8, cuda), X=_t(T, cuda),
                        spec=SlabSpec(kernel=tkf.rbf(1.0 / d)))
    return pack_model(model, precision=precision, sv_threshold=0.0)


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 256, 1000, 4096])
def test_decision_buckets_match_plain(cuda, k, precision, nq):
    """decision_packed at each serving bucket (nq rows padded up to it)
    launches the entry the bucket picks, of the precision's class, and
    agrees with the plain version; a second launch is bitwise the
    first."""
    from repro_torch.serve.scorer import bucket_for
    tk = _kern(k)
    sm = _packed_model(cuda, precision)
    rng = np.random.default_rng(16)
    b = bucket_for(nq)
    q = torch.zeros((b, 128), device=cuda)
    q[:nq] = _t(rng.standard_normal((nq, 128)) / np.sqrt(128), cuda)
    out = tdec.decision_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms, 0.2,
                               0.8, tk, tm=min(b, 256), tn=sm.tn,
                               precision=precision)
    cfg = tdec.DECISION.last_config
    assert cfg == ttil.packed_decision_config(b, precision)
    assert (ttil.kernel_of("decision", cfg) == "wgmma") == (
        precision != "f32")
    ops = tdec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                              tm=min(b, 256), tn=sm.tn, precision=precision)
    again = tdec.launch(*ops, 0.2, 0.8, tk, cfg)()
    torch.cuda.synchronize()
    assert _bitwise(out, again)
    plain = decision_plain(*ops, 0.2, 0.8, kind=k[0], gamma=k[1],
                           coef0=k[2], degree=k[3])
    _close(out[:nq], plain[:nq])


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_decision_zero_sv_model(cuda, precision):
    """A model whose weights are all zero serves (s - rho1)(rho2 - s) at
    s = 0 exactly: every split's partial is +0."""
    sm = _packed_model(cuda, precision, zero=True)
    q = _t(np.random.default_rng(17).standard_normal((64, 128)), cuda)
    out = tdec.decision_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms, 0.2,
                               0.8, tkf.rbf(0.5), tm=64, tn=sm.tn,
                               precision=precision)
    r1, r2 = torch.tensor(0.2), torch.tensor(0.8)        # f32, as passed
    assert torch.equal(out.cpu(), torch.full((64,), float((0 - r1) *
                                                          (r2 - 0))))


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("nq,nt,d", [(77, 1000, 45), (300, 33, 129),
                                     (5, 4097, 128)])
def test_unpacked_decision_ragged_entries(cuda, k, precision, nq, nt, d):
    """The unpacked decision at ragged shapes (support rows no multiple of
    SW, d no multiple of 8): every entry of the precision's class agrees
    with the plain version on the unpadded rows and is bitwise the
    class's default; rows past nt add nothing (the same support rows
    with zero-weight rows appended give bitwise the same values)."""
    tk = _kern(k)
    rng = np.random.default_rng(18)
    q = _t(rng.standard_normal((nq, d)) / np.sqrt(d), cuda)
    t = _t(rng.standard_normal((nt, d)) / np.sqrt(d), cuda)
    g = _t(np.abs(rng.standard_normal(nt)) * 0.05, cuda)
    ops = tdec.prepare(q, t, g, precision=precision)
    base = tdec.launch(*ops, 0.2, 0.8, tk, ttil.default_config(
        "decision", precision=precision))()
    for cfg in ttil.menu("decision", precision=precision):
        out = tdec.launch(*ops, 0.2, 0.8, tk, cfg)()
        torch.cuda.synchronize()
        assert _bitwise(out, base), cfg
    dt = tprec.tile_dtype(precision)
    qr, tr = tfup.as_tile(q, dt), tfup.as_tile(t, dt)
    plain = decision_plain(qr, tr, g, tfup.row_norms(qr), tfup.row_norms(tr),
                           0.2, 0.8, kind=k[0], gamma=k[1], coef0=k[2],
                           degree=k[3])
    _close(base, plain)
    pad = tdec.prepare(q, torch.cat([t, torch.ones((70, d), device=cuda)]),
                       torch.cat([g, torch.zeros(70, device=cuda)]),
                       precision=precision)
    assert _bitwise(tdec.launch(*pad, 0.2, 0.8, tk, ttil.default_config(
        "decision", precision=precision))(), base)
    wrapped = tdec.decision(q, t, g, 0.2, 0.8, tk, precision=precision)
    assert _bitwise(wrapped, tdec.decision(q, t, g, 0.2, 0.8, tk,
                                           precision=precision))
    _close(wrapped, plain)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("d", [768, 896, 1664, 2048])
def test_decision_serves_wide_rows_at_every_bucket(cuda, precision, d):
    """16-bit decision at embedding widths past the resident query tile of
    some entries (640-1664): every bucket launches an entry that fits d
    (the streamed one above 1664), none is refused, and each agrees with
    the plain version without a flipped sign."""
    sm = _packed_model(cuda, precision, n_sv=1000, d=d)
    rng = np.random.default_rng(20)
    for b in (64, 256, 1024, 4096):
        q = torch.zeros((b, sm.t_pad.shape[1]), device=cuda)
        q[:, :d] = _t(rng.standard_normal((b, d)) / np.sqrt(d), cuda)
        out = tdec.decision_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                                   0.2, 0.8, sm.spec.kernel, tm=min(b, 256),
                                   tn=sm.tn, precision=precision)
        cfg = tdec.DECISION.last_config
        assert cfg == ttil.packed_decision_config(b, precision,
                                                  sm.t_pad.shape[1])
        assert ttil.wgmma_fits(cfg, sm.t_pad.shape[1])
        ops = tdec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                                  tm=min(b, 256), tn=sm.tn,
                                  precision=precision)
        plain = decision_plain(*ops, 0.2, 0.8, kind="rbf",
                               gamma=sm.spec.kernel.gamma)
        _close(out, plain)
        sure = plain.abs() > 1e-2 * plain.abs().median()
        assert torch.equal(torch.sign(out[sure]), torch.sign(plain[sure]))
    wrapped = tdec.decision(q[:, :d], sm.model.X, sm.model.gamma, 0.2, 0.8,
                            sm.spec.kernel, precision=precision)
    assert ttil.wgmma_fits(tdec.DECISION.last_config, q.shape[1])
    _close(wrapped, plain)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_streamed_tile_is_bitwise_the_resident_one(cuda, precision):
    """At d = 768 the streamed entry and every resident entry that fits
    give bitwise the same values: decision (query tile) and fupdate's
    wgmma class (X tile) alike."""
    rng = np.random.default_rng(21)
    d = 768
    q = _t(rng.standard_normal((300, d)) / np.sqrt(d), cuda)
    t = _t(rng.standard_normal((1000, d)) / np.sqrt(d), cuda)
    tk = tkf.rbf(1.0 / d)
    ops = tdec.prepare(q, t, _t(np.abs(rng.standard_normal(1000)) * 0.05,
                                cuda), precision=precision)
    fup = tfup.prepare(t, q[:200], _t(rng.standard_normal(200) * 0.05, cuda),
                       _t(rng.standard_normal(1000), cuda),
                       precision=precision)
    for family, run in (
            ("decision", lambda c: tdec.launch(*ops, 0.2, 0.8, tk, c)()),
            ("fupdate", lambda c: tfup.launch(*fup, tk, c)())):
        cls = [c for c in ttil.menu(family, 200, precision)
               if ttil.wgmma_fits(c, d)]
        kinds = {ttil.kernel_of(family, c) for c in cls}
        assert kinds == {"wgmma", "stream"}
        outs = [run(c) for c in cls]
        torch.cuda.synchronize()
        for c, out in zip(cls, outs):
            assert _bitwise(out, outs[0]), (family, c)


# -- shrinking and warm starts through the fused provider -------------------

def _fupdate_by_class():
    narrow = {c.entry for c in ttil.menu("fupdate", 16)}
    by = tfup.FUPDATE.by_entry
    n = sum(v for e, v in by.items() if e in narrow)
    return n, sum(by.values()) - n


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_shrinking_on_the_card_matches_the_cpu(cuda, precision):
    """The repack driver with the fused provider on the card (its inner
    solves launch fupdate) against the plain provider on the CPU."""
    X, _ = make_toy(3, 600, d=16)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 16))
    kw = dict(strategy="shrinking", gram_mode="pallas", P=8, tol=1e-3,
              precision=precision, warm_iters=50)
    n0 = tfup.FUPDATE.launches
    on_card = repro_torch.fit(X, spec, **kw)
    assert tfup.FUPDATE.launches - n0 >= int(on_card.iters) > 0
    on_cpu = repro_torch.fit(X, spec, device="cpu", **kw)
    assert bool(on_card.converged) and bool(on_cpu.converged)
    np.testing.assert_allclose(
        [float(on_card.model.rho1), float(on_card.model.rho2)],
        [float(on_cpu.model.rho1), float(on_cpu.model.rho2)], atol=5e-3)
    g = on_card.model.gamma.double()
    assert float(g.sum()) == pytest.approx(spec.total(), abs=1e-5)


def test_fit_update_on_the_card_reconciles_with_the_wide_class(cuda):
    """A 10% expiry + append: the warm reconcile is one wide fupdate
    launch (S = the corrections > 32), each iteration one more (wide when
    the delta-scaled P makes 2P > 32), and the warm fit lands on the cold
    fit's objective."""
    from repro_torch.core.engine import artifact_from_result
    from repro_torch.core.ocssvm import dual_objective_matfree
    X, _ = make_toy(4, 1200, d=16)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 16))
    kw = dict(strategy="pallas", tol=1e-4)
    prev = repro_torch.fit(X[:1100], spec, **kw)
    X_new = X[100:]
    tfup.FUPDATE.reset_counts()
    st = {}
    warm = repro_torch.fit_update(artifact_from_result(prev), X_new,
                                  stats_out=st, **kw)
    narrow, wide = _fupdate_by_class()
    assert st["mode"] == "warm" and st["n_corr"] > 32
    iters = int(warm.iters)
    assert narrow + wide == iters + 1
    assert wide == (iters + 1 if 2 * st["P"] > ttil.FUPDATE_NARROW_MAX_S
                    else 1)
    cold = repro_torch.fit(X_new, spec, **kw)
    Xd = torch.as_tensor(X_new, device=cuda)
    o_w = float(dual_objective_matfree(warm.model.gamma, Xd, spec.kernel))
    o_c = float(dual_objective_matfree(cold.model.gamma, Xd, spec.kernel))
    np.testing.assert_allclose(o_w, o_c, **tprec.truth_tolerance("f32", o_c))


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_warm_reconcile_matches_raw_scores(cuda, precision):
    """FusedGram.reconcile_scores (one wide fupdate) against the plain
    row-blocked K @ gamma0 of the provider's rows."""
    from repro_torch.core.engine import (artifact_from_result,
                                         make_provider, prepare_warm_start,
                                         raw_scores_blocked)
    X, _ = make_toy(5, 5000, d=32)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 32))
    prev = repro_torch.fit(X[:4800], spec, strategy="pallas", tol=1e-3,
                           precision=precision)
    Xn = torch.as_tensor(X[200:], device=cuda)
    ws, info = prepare_warm_start(
        artifact_from_result(prev, precision=precision), Xn, spec)
    prov = make_provider("pallas", Xn, spec.kernel, precision=precision)
    n0 = tfup.FUPDATE.launches
    f = prov.reconcile_scores(ws)
    assert tfup.FUPDATE.launches == n0 + 1 and 32 < info.n_corr <= 2048
    assert tfup.FUPDATE.last_config.entry not in {
        c.entry for c in ttil.menu("fupdate", 16)}
    _close(f, raw_scores_blocked(prov.X, ws.gamma0, spec.kernel))


# -- the serving control plane on the card ---------------------------------------

@pytest.mark.parametrize("precision,d", [("f32", 128), ("bf16", 128),
                                         ("bf16", 768)])
def test_service_and_driver_score_bitwise_like_the_scorer(cuda, precision,
                                                          d):
    """Requests coalesced by the service (groups padded to other buckets
    than each request alone, one group spanning two buckets) and flushed
    by the admission driver's thread: every request's scores are bitwise
    the scorer's for that request alone (each menu entry keeps every
    sum's order)."""
    import asyncio
    import time
    from repro_torch.serve import (AdmissionController, AsyncDriver,
                                   ScoringService)
    sm = _packed_model(cuda, precision, d=d)
    rng = np.random.default_rng(22)
    sizes = (1, 63, 64, 65, 300, 1000, 4100, 7)
    qs = [(rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
          for n in sizes]
    alone = [sm.score(q) for q in qs]
    svc = ScoringService(sm.scorer())
    handles = [svc.submit(q) for q in qs]
    n0 = tdec.DECISION.launches
    launches = svc.flush()
    assert tdec.DECISION.launches - n0 == launches >= 3
    assert len(svc.stats) >= 2
    for h, ref in zip(handles, alone):
        assert h.result().tobytes() == ref.tobytes()

    class OneModel:
        def get(self, name):
            return sm

        def quota(self, name):
            return None

    ctrl = AdmissionController(OneModel())

    async def main():
        futs = [ctrl.submit_async("m", q, deadline=time.monotonic() + 0.05)
                for q in qs]
        return await asyncio.gather(*futs)

    with AsyncDriver(ctrl):
        got = asyncio.run(main())
    for g, ref in zip(got, alone):
        assert g.tobytes() == ref.tobytes()


@pytest.mark.parametrize("precision", tprec.PRECISIONS)
def test_shm_round_trip_on_the_card_is_bitwise(cuda, precision, tmp_path):
    from repro_torch.serve import attach, live_refs, publish
    sm = _packed_model(cuda, precision)
    d = str(tmp_path)
    key = f"{d}/card-key"      # /dev/shm is the host's: a key of our own
    lease = publish(sm, key, dir=d)
    try:
        sm2, lease2 = attach(key, dir=d)
        with lease2:
            assert sm2.t_pad.device.type == "cuda"
            assert sm2.t_pad.dtype == sm.t_pad.dtype
            for a, b in ((sm2.t_pad, sm.t_pad), (sm2.t_norms, sm.t_norms),
                         (sm2.gamma_pad, sm.gamma_pad)):
                assert torch.equal(a.view(torch.int8), b.view(torch.int8))
            q = np.random.default_rng(23).standard_normal(
                (1000, 128)).astype(np.float32)
            assert sm2.score(q).tobytes() == sm.score(q).tobytes()
            assert live_refs(key, dir=d) == 2
    finally:
        lease.close()
    assert live_refs(key, dir=d) == 0


def test_registry_refresh_on_the_card_routes_warm_then_cold(cuda):
    """A drift-gated refresh on the card: an in-band append refits warm
    through fit_update (wide fupdate launches only), a shifted one cold,
    and the controller's rebuilt service scores against the new model."""
    from repro_torch.serve import AdmissionController, ModelRegistry
    X, _ = make_toy(5, 3000, d=32)
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 32))
    reg = ModelRegistry()
    reg.register("a", X[:2850], spec, tol=1e-3)
    ctrl = AdmissionController(reg)
    svc1 = ctrl.service("a")
    n0 = tfup.FUPDATE.launches
    reg.refresh("a", append=X[2850:])
    st = reg.refresh_stats("a")
    assert st["modes"] == {"warm": 1, "cold": 0}
    assert tfup.FUPDATE.launches > n0
    reg.refresh("a", append=X[:150] + 5.0)
    assert reg.refresh_stats("a")["modes"] == {"warm": 1, "cold": 1}
    assert ctrl.service("a") is not svc1
    q = X[:70]
    h = ctrl.submit("a", q)
    ctrl.drain()
    assert h.result().tobytes() == reg.get("a").score(q).tobytes()


def test_distributed_fit_on_the_card_matches_single_device(cuda, tmp_path):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    card) fit with ``strategy="distributed"``: each rank launches
    fupdate, gamma is bitwise equal on both, and the fit lands on the
    single-device fit's optimum (objective and offsets within
    truth_tolerance + 5e-3, iterations within 10%: ROADMAP C.6)."""
    import torch_dist_ranks
    from repro_torch.core.ocssvm import dual_objective_matfree
    from repro_torch.launch import spawn_ranks
    X, _ = make_toy(11, 1024, d=16)
    ranks = spawn_ranks(torch_dist_ranks.card_fit, 2, backend="gloo",
                        args=(dict(X=X, precision="f32"),), timeout_s=300,
                        dir=str(tmp_path))
    assert all(r["launches"] >= r["iters"] > 0 for r in ranks)
    assert all(r["device"].startswith("cuda") for r in ranks)
    assert ranks[0]["gamma"].tobytes() == ranks[1]["gamma"].tobytes()
    assert ranks[0]["iters"] == ranks[1]["iters"] and ranks[0]["converged"]
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(1 / 16))
    single = repro_torch.fit(X, spec, strategy="pallas", P=8, tol=1e-3)
    Xd = torch.as_tensor(X, device=cuda).double()
    o_d = float(dual_objective_matfree(
        torch.as_tensor(ranks[0]["gamma"], device=cuda).double(), Xd,
        spec.kernel))
    o_s = float(dual_objective_matfree(single.model.gamma.double(), Xd,
                                       spec.kernel))
    tol = tprec.truth_tolerance("f32", [o_s])
    assert abs(o_d - o_s) <= max(tol["atol"], 5e-3) + tol["rtol"] * abs(o_s)
    rho_s = [float(single.model.rho1), float(single.model.rho2)]
    np.testing.assert_allclose(ranks[0]["rho"], rho_s, atol=5e-3)
    i_s = int(single.iters)
    assert abs(ranks[0]["iters"] - i_s) <= max(1, 0.1 * i_s)

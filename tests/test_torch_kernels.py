"""The port's kernel families held against the JAX package.

The same numpy inputs go to ``repro.kernels.*.ops`` (Pallas in interpret
mode, as tests/test_kernels.py runs it) and to the port's wrappers, which
run their plain versions on CPU tensors. Both sides round the data rows
to the tile dtype the same way (round to nearest even), so the two differ
only by the f32 summation order: they are compared at the f32 tolerance
of ``TOLERANCES``, and the port's low-precision output against the f32
truth at ``truth_tolerance(precision)``.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kernel_fn as jkf
from repro.kernels.decision.ops import decision_packed as j_decision_packed
from repro.kernels.fupdate.ops import fupdate as j_fupdate
from repro.kernels.fupdate.ref import fupdate_ref as j_fupdate_ref
from repro.kernels.precision import (PRECISIONS, TOLERANCES, round_to_tile,
                                     truth_tolerance)
from repro.kernels.precision import tile_dtype as j_tile_dtype
import repro_torch.core.kernel_fn as tkf
from repro_torch.kernels import precision as tprec
from repro_torch.kernels.decision import ops as tdec
from repro_torch.kernels.decision.ref import decision_plain, decision_ref
from repro_torch.kernels.fupdate import ops as tfup
from repro_torch.kernels.fupdate.ref import fupdate_plain, fupdate_ref
from repro_torch.serve.model_cache import pack_model
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec

# (name, gamma, coef0, degree): poly at degree 3 takes the odd branch of
# the repeated-squaring power.
KERNELS = [("linear", 1.0, 0.0, 3), ("rbf", 0.35, 0.0, 3),
           ("poly", 0.2, 1.0, 2), ("poly", 0.2, 1.0, 3)]
KIDS = ["linear", "rbf", "poly2", "poly3"]


def _kern_pair(k):
    name, g, c0, deg = k
    return (jkf.KernelFn(name=name, gamma=g, coef0=c0, degree=deg),
            tkf.KernelFn(name=name, gamma=g, coef0=c0, degree=deg))


def _data(seed, m, d, s):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d)).astype(np.float32)
    delta = (rng.standard_normal(s) * 0.1).astype(np.float32)
    f = rng.standard_normal(m).astype(np.float32)
    return X, delta, f


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **tol)


# -- precision / kernel functions -------------------------------------------

def test_precision_tables_match_reference():
    assert tprec.PRECISIONS == PRECISIONS
    assert tprec.TOLERANCES == TOLERANCES
    with pytest.raises(ValueError):
        tprec.check_precision("tf32")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_round_to_tile_bitwise(precision):
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32)
    j = np.asarray(round_to_tile(jnp.asarray(x), precision))
    t = tprec.round_to_tile(_t(x), precision).numpy()
    assert np.array_equal(j, t)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
def test_cross_and_diag_match_jax(k, precision):
    jk, tk = _kern_pair(k)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((50, 13)).astype(np.float32)
    Y = rng.standard_normal((21, 13)).astype(np.float32)
    Xj = round_to_tile(jnp.asarray(X), precision)
    Yj = round_to_tile(jnp.asarray(Y), precision)
    Xt = tprec.round_to_tile(_t(X), precision)
    Yt = tprec.round_to_tile(_t(Y), precision)
    ref = np.asarray(jk.cross(Xj, Yj))
    _close(tk.cross(Xt, Yt), ref, truth_tolerance("f32", ref))
    dref = np.asarray(jk.diag(Xj))
    _close(tk.diag(Xt), dref, truth_tolerance("f32", dref))


def test_rbf_clamps_negative_squared_distance():
    # Identical rows: rn + cn - 2 dot can round below 0; the clamp keeps
    # k(x, x) <= 1, as in the JAX package.
    x = _t(np.full((1, 7), 1.1, np.float32))
    k = tkf.rbf(3.0).cross(x, x)
    assert float(k[0, 0]) <= 1.0


# -- fupdate ----------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("m,d,s", [(200, 33, 20)])
def test_fupdate_matches_jax(k, precision, m, d, s):
    jk, tk = _kern_pair(k)
    X, delta, f = _data(2, m, d, s)
    Xs = X[:s]
    j_out = np.asarray(j_fupdate(jnp.asarray(X), jnp.asarray(Xs),
                                 jnp.asarray(delta), jnp.asarray(f), jk,
                                 interpret=True, precision=precision))
    t_out = tfup.fupdate(_t(X), _t(Xs), _t(delta), _t(f), tk,
                         precision=precision)
    # Same rounded inputs on both sides: f32 summation order only.
    _close(t_out, j_out, truth_tolerance("f32", j_out))
    j_ref = np.asarray(j_fupdate_ref(
        jnp.asarray(X), jnp.asarray(Xs), jnp.asarray(delta), jnp.asarray(f),
        kind=k[0], gamma=k[1], coef0=k[2], degree=k[3],
        precision=precision))
    t_ref = fupdate_ref(_t(X), _t(Xs), _t(delta), _t(f), kind=k[0],
                        gamma=k[1], coef0=k[2], degree=k[3],
                        precision=precision)
    _close(t_ref, j_ref, truth_tolerance("f32", j_ref))
    truth = fupdate_ref(_t(X), _t(Xs), _t(delta), _t(f), kind=k[0],
                        gamma=k[1], coef0=k[2], degree=k[3])
    _close(t_out, truth, truth_tolerance(precision, truth))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
def test_fupdate_zero_rows_add_nothing(k, precision):
    """Zero rows with zero deltas appended to the selected block leave f
    unchanged: bitwise for linear and rbf; for poly within 2 ulp of |f|,
    the bound ROADMAP C.1 records for the JAX package's own poly path."""
    _, tk = _kern_pair(k)
    m, d, s = 96, 17, 5
    X, delta, f = _data(7, m, d, s)
    out = tfup.fupdate(_t(X), _t(X[:s]), _t(delta), _t(f), tk,
                       precision=precision)
    for extra in (3, 128):
        Xs = np.concatenate([X[:s], np.zeros((extra, d), np.float32)])
        dl = np.concatenate([delta, np.zeros(extra, np.float32)])
        out_pad = tfup.fupdate(_t(X), _t(Xs), _t(dl), _t(f), tk,
                               precision=precision)
        if k[0] == "poly":
            ulp = np.spacing(np.abs(out.numpy()))
            assert np.all(np.abs(out_pad.numpy() - out.numpy()) <= 2 * ulp)
        else:
            assert torch.equal(out, out_pad)


def test_fupdate_precomputed_norms_and_zero_delta():
    _, tk = _kern_pair(KERNELS[1])
    X, delta, f = _data(3, 64, 9, 4)
    xt = _t(X)
    a = tfup.fupdate(xt, xt[:4], _t(delta), _t(f), tk)
    b = tfup.fupdate(xt, xt[:4], _t(delta), _t(f), tk,
                     xn=tfup.row_norms(xt))
    assert torch.equal(a, b)
    z = tfup.fupdate(xt, xt[:4], torch.zeros(4), _t(f), tk)
    assert torch.equal(z, _t(f))


def test_fupdate_rejects_bad_shapes():
    _, tk = _kern_pair(KERNELS[0])
    X, delta, f = _data(3, 16, 4, 3)
    with pytest.raises(ValueError):
        tfup.fupdate(_t(X), _t(X[:3, :2]), _t(delta), _t(f), tk)
    with pytest.raises(ValueError):
        tfup.fupdate(_t(X), _t(X[:3]), _t(delta), _t(f[:5]), tk)


# -- decision ---------------------------------------------------------------

def _packed(precision, n_sv=300, d=20, seed=4):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((n_sv, d)).astype(np.float32)
    gv = (rng.standard_normal(n_sv) * 0.05).astype(np.float32)
    return T, gv


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
def test_decision_packed_matches_jax(k, precision):
    jk, tk = _kern_pair(k)
    T, gv = _packed(precision)
    spec = SlabSpec(kernel=tk)
    model = OCSSVMModel(gamma=_t(gv), rho1=_t(0.2), rho2=_t(0.8), X=_t(T),
                        spec=spec)
    sm = pack_model(model, precision=precision, sv_threshold=0.0)
    nq = 100
    Q = np.random.default_rng(5).standard_normal((nq, T.shape[1])) \
        .astype(np.float32)
    q_pad = np.zeros((256, sm.t_pad.shape[1]), np.float32)
    q_pad[:nq, :T.shape[1]] = Q
    t_out = tdec.decision_packed(_t(q_pad), sm.t_pad, sm.gamma_pad,
                                 sm.t_norms, 0.2, 0.8, tk,
                                 precision=precision)[:nq]
    j_out = np.asarray(j_decision_packed(
        jnp.asarray(q_pad),
        jnp.asarray(sm.t_pad.float().numpy()).astype(j_tile_dtype(precision)),
        jnp.asarray(sm.gamma_pad.numpy()), jnp.asarray(sm.t_norms.numpy()),
        0.2, 0.8, jk, interpret=True, precision=precision))[:nq]
    _close(t_out, j_out, truth_tolerance("f32", j_out))
    truth = decision_ref(_t(Q), _t(T), _t(gv), 0.2, 0.8, kind=k[0],
                         gamma=k[1], coef0=k[2], degree=k[3])
    _close(t_out, truth, truth_tolerance(precision, truth))


def test_decision_matches_packed():
    _, tk = _kern_pair(KERNELS[1])
    T, gv = _packed("f32", n_sv=70, d=9)
    Q = np.random.default_rng(6).standard_normal((33, 9)).astype(np.float32)
    a = tdec.decision(_t(Q), _t(T), _t(gv), 0.1, 0.9, tk)
    b = decision_ref(_t(Q), _t(T), _t(gv), 0.1, 0.9, kind="rbf",
                     gamma=tk.gamma)
    _close(a, b, truth_tolerance("f32", b))


def test_decision_packed_rejects_misaligned():
    _, tk = _kern_pair(KERNELS[0])
    with pytest.raises(ValueError):
        tdec.decision_packed(torch.zeros((100, 128)), torch.zeros((512, 128)),
                             torch.zeros((512, 1)), torch.zeros((512, 1)),
                             0.0, 1.0, tk, tm=64, tn=512)
    with pytest.raises(ValueError):
        tdec.decision_packed(torch.zeros((64, 100)), torch.zeros((512, 100)),
                             torch.zeros((512, 1)), torch.zeros((512, 1)),
                             0.0, 1.0, tk, tm=64, tn=512)
    with pytest.raises(ValueError):
        tdec.decision_packed(torch.zeros((64, 128)), torch.zeros((512, 256)),
                             torch.zeros((512, 1)), torch.zeros((512, 1)),
                             0.0, 1.0, tk, tm=64, tn=512)


def test_wrappers_refuse_other_devices():
    _, tk = _kern_pair(KERNELS[0])
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tfup.fupdate(x, x, torch.zeros(4, device="meta"),
                     torch.zeros(4, device="meta"), tk)


# -- building and binding -----------------------------------------------------

def test_build_names_and_library_paths():
    from repro_torch.kernels import _build
    assert _build.sources() == ["decision", "fupdate", "gram"]
    a, b = _build.library_path("fupdate"), _build.library_path("decision")
    assert a.parent == _build.BUILD_DIR and a != b
    assert a.name.startswith("fupdate-") and a.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_kernel_launch_raises_on_cuda_error_and_counts_successes():
    from repro_torch.kernels._build import Kernel
    k = Kernel("fupdate", "fupdate_launch", [])
    codes = iter([0, 700])
    k._fn = lambda *a: next(codes)
    k._err_str = lambda err: b"an illegal memory access was encountered"
    k.launch()
    assert k.launches == 1
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k.launch()
    assert k.launches == 1


def _stub_stream(monkeypatch):
    import types
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))


@pytest.mark.parametrize("family", ["fupdate", "decision", "gram"])
def test_launch_arguments_match_the_c_signature(monkeypatch, family):
    """The prepared launch marshals one argument per declared C parameter,
    each of the declared ctypes type, the stream last and the menu index
    of its config before it."""
    from repro_torch.kernels import tiling
    from repro_torch.kernels.gram import ops as tgram
    import ctypes
    _stub_stream(monkeypatch)
    _, tk = _kern_pair(KERNELS[1])
    X, delta, f = _data(4, 12, 5, 3)
    if family == "fupdate":
        ops = tfup.prepare(_t(X), _t(X[:3]), _t(delta), _t(f),
                           precision="bf16")
        launch = tfup.launch(*ops, tk)
    elif family == "decision":
        ops = tdec.prepare_packed(torch.zeros((64, 128)),
                                  torch.zeros((512, 128)),
                                  torch.ones((512, 1)), torch.ones((512, 1)),
                                  tm=64, tn=512, precision="bf16")
        launch = tdec.launch(*ops, 0.1, 0.9, tk)
    else:
        ops = tgram.prepare(_t(X), _t(X[:7]), precision="bf16")
        launch = tgram.launch(*ops, tk)
    assert launch.config == tiling.default_config(family, 3, "bf16")
    assert launch.args[-2] == tiling.menu_index(family, launch.config)
    assert len(launch.args) == len(launch.kernel.argtypes)
    for arg, ctype in zip(launch.args, launch.kernel.argtypes):
        ctype(arg)              # raises TypeError on a mismatched type
    assert launch.args[-1] == 7
    assert launch.out.data_ptr() in launch.args
    assert launch.out.dtype == torch.float32


def test_launch_runs_its_kernel_and_returns_its_output():
    from repro_torch.kernels._build import Kernel, Launch
    seen = []
    k = Kernel("fupdate", "fupdate_launch", [])
    k._fn = lambda *a: seen.append(a) or 0
    out = torch.zeros(3)
    # Device -1 leaves the current card as it is (no card here).
    launch = Launch(k, -1, (1, 2), out)
    assert launch() is out and launch() is out
    assert seen == [(1, 2), (1, 2)] and k.launches == 2


def test_launches_are_counted_by_menu_entry():
    """Kernel.by_entry splits the launch count by the entry of each
    launch's config (how fupdate's narrow launches are told from its
    wide ones); reset_counts zeroes both counts."""
    from repro_torch.kernels import tiling
    from repro_torch.kernels._build import Kernel, Launch
    k = Kernel("fupdate", "fupdate_launch", [])
    k._fn = lambda *a: 0
    narrow = tiling.default_config("fupdate", 16)
    wide = tiling.default_config("fupdate", 128)
    for cfg in (narrow, wide, wide, None):
        Launch(k, -1, (), torch.zeros(1), cfg)()
    assert k.launches == 4
    assert k.by_entry == {narrow.entry: 1, wide.entry: 2}
    k.reset_counts()
    assert k.launches == 0 and not k.by_entry

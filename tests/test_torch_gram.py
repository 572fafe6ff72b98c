"""The port's ``gram`` family held against the JAX package, on the CPU.

The same numpy inputs go to ``repro.kernels.gram.ops.gram`` (Pallas in
interpret mode, as tests/test_kernels.py runs it) and ``gram_ref``, and to
the port's ``gram`` wrapper, which runs its plain version
(``gram_plain``) on CPU tensors. Both sides round the rows to the tile
dtype the same way, so they differ only by the f32 summation order and
are compared at the f32 tolerance of ``TOLERANCES``; the port's
low-precision output is held against the f32 truth at
``truth_tolerance(precision)``.

The CUDA kernel itself is held against ``gram_plain`` on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kernel_fn as jkf
from repro.kernels.gram.ops import gram as j_gram
from repro.kernels.gram.ref import gram_ref as j_gram_ref
from repro.kernels.precision import PRECISIONS, truth_tolerance
import repro_torch.core.kernel_fn as tkf
import repro_torch.kernels as tkernels
from repro_torch.core.kernel_fn import apply_epilogue
from repro_torch.kernels.gram import ops as tgram
from repro_torch.kernels.gram.ref import gram_plain

KERNELS = [("linear", 1.0, 0.0, 3), ("rbf", 0.35, 0.0, 3),
           ("poly", 0.2, 1.0, 2), ("poly", 0.2, 1.0, 3)]
KIDS = ["linear", "rbf", "poly2", "poly3"]


def _kw(k):
    name, g, c0, deg = k
    return dict(kind=name, gamma=g, coef0=c0, degree=deg)


def _rows(seed, m, n, d):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("m,n,d", [(50, 21, 13), (130, 77, 129)])
def test_gram_matches_jax(k, precision, m, n, d):
    X, Y = _rows(1, m, n, d)
    jk = jkf.KernelFn(name=k[0], gamma=k[1], coef0=k[2], degree=k[3])
    tk = tkf.KernelFn(name=k[0], gamma=k[1], coef0=k[2], degree=k[3])
    n0 = tgram.GRAM.launches
    t_out = tgram.gram(torch.as_tensor(X), torch.as_tensor(Y), tk,
                       precision=precision)
    assert tgram.GRAM.launches == n0           # the CPU runs no kernel
    assert t_out.shape == (m, n) and t_out.dtype == torch.float32
    j_out = np.asarray(j_gram(jnp.asarray(X), jnp.asarray(Y), jk,
                              interpret=True, precision=precision))
    # Same rounded inputs on both sides: f32 summation order only.
    _close(t_out, j_out, truth_tolerance("f32", j_out))
    j_ref = np.asarray(j_gram_ref(jnp.asarray(X), jnp.asarray(Y),
                                  precision=precision, **_kw(k)))
    t_ref = gram_plain(torch.as_tensor(X), torch.as_tensor(Y),
                       precision=precision, **_kw(k))
    _close(t_ref, j_ref, truth_tolerance("f32", j_ref))
    truth = np.asarray(j_gram_ref(jnp.asarray(X), jnp.asarray(Y), **_kw(k)))
    _close(t_out, truth, truth_tolerance(precision, truth))


def test_gram_wrapper_is_its_plain_version_on_the_cpu():
    X, Y = _rows(2, 40, 33, 9)
    x, y = torch.as_tensor(X), torch.as_tensor(Y)
    tk = tkf.rbf(0.7)
    out = tgram.gram(x, y, tk, precision="bf16")
    assert torch.equal(out, gram_plain(x, y, kind="rbf", gamma=0.7,
                                       precision="bf16"))
    # Explicit tiles on the menu change nothing on the CPU ...
    assert torch.equal(out, tgram.gram(x, y, tk, tm=128, tn=128,
                                       precision="bf16"))
    # ... and tiles off the menu are refused there too.
    with pytest.raises(ValueError, match="menu"):
        tgram.gram(x, y, tk, tm=100)
    with pytest.raises(ValueError, match="menu"):
        tgram.gram(x, y, tk, tk=128)


def test_gram_is_exported_and_refuses_bad_operands():
    assert tkernels.gram is tgram.gram
    tk = tkf.linear()
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros((4, 3)), torch.zeros((5, 2)), tk)
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tgram.gram(x, x, tk)
    assert tgram.gram(torch.zeros((0, 3)), torch.zeros((5, 3)),
                      tk).shape == (0, 5)


def test_gram_plain_rbf_clamps_and_matches_cross():
    """Identical rows give k(x, x) <= 1 (the clamp), and f32 gram_plain is
    KernelFn.cross bit for bit: one epilogue, core/kernel_fn.py."""
    X, _ = _rows(3, 30, 1, 7)
    x = torch.as_tensor(X)
    k = gram_plain(x, x, kind="rbf", gamma=3.0)
    assert float(k.diagonal().max()) <= 1.0
    for kind, kern in (("rbf", tkf.rbf(3.0)), ("linear", tkf.linear()),
                       ("poly", tkf.poly(0.5, 1.0, 3))):
        assert torch.equal(gram_plain(x, x, kind=kind, gamma=kern.gamma,
                                      coef0=kern.coef0, degree=kern.degree),
                           kern.cross(x, x))


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("k", KERNELS, ids=KIDS)
@pytest.mark.parametrize("d", [45, 129])
def test_feature_pad_for_tma_changes_no_value(k, precision, d):
    """prepare lays 16-bit rows out for TMA: features zero-padded to a
    multiple of 8 after rounding, norms of the unpadded rows. The plain
    version of the padded operands is bitwise that of the unpadded ones:
    for linear and poly as they are; for rbf with the norms prepare took
    before padding (gram_plain's own torch.sum over 48 or 136 features
    may sum in another order than over 45 or 129)."""
    X, Y = _rows(4, 203, 77, d)
    x, y = torch.as_tensor(X), torch.as_tensor(Y)
    xp, yp, xn, yn = tgram.prepare(x, y, precision=precision)
    dp = -(-d // tgram.TMA_FEATURES) * tgram.TMA_FEATURES
    assert xp.shape == (203, dp) and yp.shape == (77, dp)
    assert xp.data_ptr() % 16 == 0 and yp.data_ptr() % 16 == 0
    assert not xp[:, d:].any() and not yp[:, d:].any()
    x16, y16 = tfup_rounded(x, precision), tfup_rounded(y, precision)
    assert torch.equal(xp[:, :d], x16) and torch.equal(yp[:, :d], y16)
    assert torch.equal(xn, torch.sum(x16.float() ** 2, dim=-1))
    kw = _kw(k)
    plain = gram_plain(x, y, precision=precision, **kw)
    if k[0] == "rbf":
        xf, yf = xp.float(), yp.float()
        padded = apply_epilogue(xf @ yf.T, xn[:, None], yn[None, :], **kw)
    else:
        padded = gram_plain(xp, yp, precision=precision, **kw)
    assert torch.equal(padded, plain)
    # The wrapper's CPU path is the plain version of the caller's rows.
    assert torch.equal(tgram.gram(x, y, tkf.KernelFn(name=k[0], gamma=k[1],
                                                     coef0=k[2],
                                                     degree=k[3]),
                                  precision=precision), plain)


def test_tma_rows_copy_a_misaligned_base_and_leave_f32_alone():
    base = torch.zeros(1 + 40 * 16, dtype=torch.bfloat16)
    rows = base[1:].view(40, 16)            # 2 bytes past an aligned base
    assert rows.data_ptr() % 16 != 0
    laid = tgram.tma_rows(rows)
    assert laid.data_ptr() % 16 == 0 and torch.equal(laid, rows)
    aligned = torch.ones((8, 24), dtype=torch.bfloat16)
    assert tgram.tma_rows(aligned) is aligned   # nothing to do
    x = torch.ones((5, 45))
    xp, yp, _, _ = tgram.prepare(x, x, precision="f32")
    assert xp.shape == (5, 45) and yp.shape == (5, 45)   # f32: no pad


def tfup_rounded(a, precision):
    from repro_torch.kernels.precision import tile_dtype
    return a.to(tile_dtype(precision))

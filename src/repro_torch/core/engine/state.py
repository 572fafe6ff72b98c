"""Warm-start solver state as a first-class, checkpointable artifact.

The SMO decomposition is naturally warm-startable: the driver's
``SolverState`` (gamma, f-cache) is a valid restart point for any nearby
problem. This module makes that restart point public:

* ``SolverArtifact`` — everything a later solve needs to warm-start from
  a finished fit: gamma, the final f-cache, the training rows, per-row
  content hashes (for overlap matching against new data), the concrete
  spec and precision. ``save``/``load`` round-trip it through one
  ``.npz`` file in the JAX package's layout, so an artifact saved by
  either package loads in the other.
* ``prepare_warm_start(prev, X_new, spec)`` — align a prior artifact
  with a *new* training set (rows appended, expired, or both), seed
  gamma from the overlapping rows, clip it back into the new slab box,
  repair the equality constraint with a minimal-touch water-fill, and
  emit the sparse **correction set** whose single fused ``fupdate``
  sweep turns the prior f-cache into the new problem's f-cache — no
  O(m^2) recompute.

The f-cache algebra: let C be the *assumed* configuration — the prior
gamma carried over to the surviving rows (zero on appended rows) plus
the prior gamma still sitting on the expired rows. The prior f-cache IS
the score of every surviving row under C, appended rows get their score
under C in one O(dm * m) pass, and the warm seed ``gamma0`` differs
from C only on a sparse set: clipped coordinates, water-fill touches,
and the expired rows. One rank-s update f += k(X, X_corr) @ delta lands
every row on K_new @ gamma0 (up to f32 reassociation).

Matching, clipping and the equality repair are host-side float64 numpy,
as in the reference; the score passes run on the device of the new rows.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Coefficients smaller than this are "zero" for correction purposes: an
# expired row carrying |gamma| below it never contributed measurably to
# any score, so it needs no correction column.
_GAMMA_ZERO = 1e-12


class WarmStart(NamedTuple):
    """The warm seed a solver facade threads into the engine, on the
    solve's device. Build it with ``prepare_warm_start`` — the invariant
    the engine relies on is
    ``f_seed + k(X_new, x_corr) @ delta == K_new @ gamma0``."""

    gamma0: Tensor    # (m,) feasible warm gamma for the NEW problem
    f_seed: Tensor    # (m,) scores of the assumed (prior) configuration
    x_corr: Tensor    # (s, d) rows whose coefficient changed vs assumed
    delta: Tensor     # (s,) the coefficient deltas


@dataclasses.dataclass(frozen=True)
class WarmStartInfo:
    """Host-side accounting for one prepared warm start."""

    m: int             # new problem size
    m_prev: int        # prior problem size
    n_overlap: int     # new rows seeded from the prior fit
    n_fresh: int       # appended rows (no prior gamma/f)
    n_expired: int     # prior rows absent from the new set
    n_corr: int        # correction columns in the fused sweep
    overlap_frac: float  # n_overlap / m — the fallback-routing signal


def host_f32(X) -> np.ndarray:
    """A C-contiguous f32 numpy copy of rows on any device."""
    if isinstance(X, torch.Tensor):
        X = X.detach().to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(np.asarray(X, np.float32))


def row_hashes(X) -> np.ndarray:
    """Per-row 64-bit content hashes (blake2b) of the f32 bytes of ``X``,
    read from a host copy: a row hashes the same in both packages and on
    any device. A hash collision here would seed a *wrong f-cache*, which
    the solver trusts rather than repairs, so no positional sample."""
    a = host_f32(X)
    if a.ndim != 2:
        raise ValueError(f"expected (m, d) rows, got shape {a.shape}")
    out = np.empty(a.shape[0], np.uint64)
    for i, row in enumerate(a):
        out[i] = int.from_bytes(
            hashlib.blake2b(row.tobytes(), digest_size=8).digest(), "little")
    return out


def match_rows(prev_hashes: np.ndarray, new_hashes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-to-one alignment of new rows onto prior rows by content hash.

    Returns ``(new_ov, prev_ov, new_fresh, prev_expired)`` index arrays:
    ``new[new_ov[k]]`` is the same row as ``prev[prev_ov[k]]``;
    duplicated rows match multiset-style (each prior copy is consumed at
    most once).
    """
    pool: dict = {}
    for j, h in enumerate(prev_hashes.tolist()):
        pool.setdefault(h, []).append(j)
    new_ov, prev_ov, new_fresh = [], [], []
    for i, h in enumerate(new_hashes.tolist()):
        js = pool.get(h)
        if js:
            new_ov.append(i)
            prev_ov.append(js.pop())
        else:
            new_fresh.append(i)
    expired = sorted(j for js in pool.values() for j in js)
    return (np.asarray(new_ov, np.int64), np.asarray(prev_ov, np.int64),
            np.asarray(new_fresh, np.int64), np.asarray(expired, np.int64))


def clip_to_box(gamma: np.ndarray, *, hi: float, lo: float,
                total: float) -> np.ndarray:
    """Project a gamma seed into the new slab box and repair the equality.

    Clip first (restores the box), then water-fill the equality residual
    into the coordinates with the MOST slack first — the minimal-touch
    repair, so the correction set stays sparse.
    """
    g = np.clip(np.asarray(gamma, np.float64), lo, hi)
    r = total - float(g.sum())
    if abs(r) <= 1e-12 * max(1.0, abs(total)):
        return g.astype(np.float32)
    slack = (hi - g) if r > 0 else (g - lo)
    step = 1.0 if r > 0 else -1.0
    order = np.argsort(-slack, kind="stable")
    need = abs(r)
    for i in order:
        if need <= 0:
            break
        take = min(need, float(slack[i]))
        g[i] += step * take
        need -= take
    if need > 1e-9 * max(1.0, abs(total)):
        raise ValueError(
            f"cannot restore sum(gamma) == {total}: the box has "
            f"insufficient slack (residual {need:.3e}) — the spec is "
            "infeasible for this m")
    return g.astype(np.float32)


@dataclasses.dataclass
class SolverArtifact:
    """A finished fit packaged as a restart point (checkpointable).

    Host numpy throughout: ``gamma``/``f`` are the solver's final dual
    vector and f-cache over ``X`` (the f32 training rows), ``hashes`` are
    ``row_hashes(X)``, ``spec`` is concrete and ``precision`` records the
    Gram tile dtype of the fit — warm starts prepared from this artifact
    round correction rows to the same tiles.
    """

    gamma: np.ndarray    # (m,) f32
    f: np.ndarray        # (m,) f32 final f-cache (K @ gamma)
    rho1: float
    rho2: float
    X: np.ndarray        # (m, d) f32 training rows
    hashes: np.ndarray   # (m,) uint64 row content hashes
    spec: object         # concrete SlabSpec
    precision: str = "f32"

    @property
    def m(self) -> int:
        return int(self.X.shape[0])

    def support_mask(self, threshold: float = 1e-7) -> np.ndarray:
        """Rows whose coefficient is nonzero (|gamma| > threshold)."""
        return np.abs(self.gamma) > threshold

    def save(self, path: str) -> None:
        """Checkpoint to one ``.npz`` (spec flattened to scalars), in the
        JAX package's layout."""
        k = self.spec.kernel
        np.savez(
            path, gamma=self.gamma, f=self.f, X=self.X, hashes=self.hashes,
            rho=np.asarray([self.rho1, self.rho2], np.float64),
            spec_scalars=np.asarray(
                [self.spec.nu1, self.spec.nu2, self.spec.eps, k.gamma,
                 k.coef0, float(k.degree)], np.float64),
            kernel_name=np.asarray(k.name),
            precision=np.asarray(self.precision))

    @classmethod
    def load(cls, path: str) -> "SolverArtifact":
        from repro_torch.core.kernel_fn import KernelFn
        from repro_torch.core.ocssvm import SlabSpec
        z = np.load(path, allow_pickle=False)
        nu1, nu2, eps, kg, kc, kd = (float(v) for v in z["spec_scalars"])
        spec = SlabSpec(nu1=nu1, nu2=nu2, eps=eps,
                        kernel=KernelFn(name=str(z["kernel_name"]),
                                        gamma=kg, coef0=kc, degree=int(kd)))
        rho1, rho2 = (float(v) for v in z["rho"])
        return cls(gamma=z["gamma"], f=z["f"], rho1=rho1, rho2=rho2,
                   X=z["X"], hashes=z["hashes"], spec=spec,
                   precision=str(z["precision"]))


def artifact_from_result(res, *, precision: str = "f32",
                         hashes: Optional[np.ndarray] = None
                         ) -> SolverArtifact:
    """Package an ``SMOResult`` as a restart point (host copies).

    Facades fill ``res.f`` (the final f-cache); a result without it gets
    the cache rebuilt with one blocked K @ gamma pass on the model's
    device.
    """
    from repro_torch.core.engine.gram import raw_scores_blocked
    from repro_torch.core.ocssvm import concrete_spec
    model = res.model
    spec = concrete_spec(model.spec)
    f = res.f
    if f is None:
        f = raw_scores_blocked(model.X.to(torch.float32), model.gamma,
                               spec.kernel)
    X = host_f32(model.X)
    return SolverArtifact(
        gamma=host_f32(model.gamma), f=host_f32(f),
        rho1=float(model.rho1), rho2=float(model.rho2), X=X,
        hashes=hashes if hashes is not None else row_hashes(X),
        spec=spec, precision=precision)


def prepare_warm_start(prev: SolverArtifact, X_new, spec, *,
                       precision: Optional[str] = None
                       ) -> Tuple[WarmStart, WarmStartInfo]:
    """Align a prior fit with a new training set and build the warm seed.

    Matching, clipping and the equality repair run on the host; the
    appended rows' seed scores are the one O(dm * m * d) pass, on X_new's
    device (the CPU for an array). The
    returned ``WarmStart`` satisfies
    ``f_seed + k(X_new, x_corr) @ delta == K_new @ gamma0`` (up to f32
    reassociation), which ``GramProvider.reconcile_scores`` folds with
    one fused sweep.

    ``precision`` defaults to the artifact's — correction rows are
    rounded to those tiles so the sweep sees the same Gram entries the
    provider streams.
    """
    from repro_torch.core.ocssvm import concrete_spec
    from repro_torch.kernels.precision import round_to_tile
    spec = concrete_spec(spec)
    if precision is None:
        precision = prev.precision
    device = (X_new.device if isinstance(X_new, torch.Tensor)
              else torch.device("cpu"))
    X32 = host_f32(X_new)
    m, d = X32.shape
    hi, lo, total = spec.upper(m), spec.lower(m), spec.total()

    def dev(a):
        return torch.as_tensor(a, device=device)

    new_ov, prev_ov, new_fresh, prev_exp = match_rows(prev.hashes,
                                                      row_hashes(X32))
    # Assumed configuration C: prior gamma on surviving rows (0 on
    # appended rows) + prior gamma still sitting on the expired rows.
    g_assumed = np.zeros(m, np.float32)
    g_assumed[new_ov] = prev.gamma[prev_ov]
    f_seed = np.zeros(m, np.float32)
    f_seed[new_ov] = prev.f[prev_ov]

    prev_exp = prev_exp[np.abs(prev.gamma[prev_exp]) > _GAMMA_ZERO]
    Xr = round_to_tile(dev(X32), precision)
    X_exp = round_to_tile(
        dev(np.asarray(prev.X, np.float32)[prev_exp].reshape(-1, d)),
        precision)
    g_exp = np.asarray(prev.gamma[prev_exp], np.float32)

    if new_fresh.size:
        # Appended rows' score under C: one O(dm * (m + e) * d) pass.
        Xf = Xr[dev(new_fresh)]
        s_fresh = spec.kernel.cross(Xf, Xr) @ dev(g_assumed)
        if prev_exp.size:
            s_fresh = s_fresh + spec.kernel.cross(Xf, X_exp) @ dev(g_exp)
        f_seed[new_fresh] = host_f32(s_fresh)

    gamma0 = clip_to_box(g_assumed, hi=hi, lo=lo, total=total)
    moved = np.nonzero(gamma0 != g_assumed)[0]
    x_corr = torch.cat([Xr[dev(moved)].reshape(-1, d), X_exp])
    delta = dev(np.concatenate([(gamma0 - g_assumed)[moved], -g_exp])
                .astype(np.float32))

    warm = WarmStart(gamma0=dev(gamma0), f_seed=dev(f_seed), x_corr=x_corr,
                     delta=delta)
    info = WarmStartInfo(
        m=m, m_prev=prev.m, n_overlap=int(new_ov.size),
        n_fresh=int(new_fresh.size), n_expired=int(prev_exp.size),
        n_corr=int(delta.shape[0]),
        overlap_frac=float(new_ov.size) / max(m, 1))
    return warm, info

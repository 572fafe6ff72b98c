"""Warm-model cache: fit once per (SlabSpec, data) fingerprint, then serve.

A cache miss does the expensive work exactly once:

1. ``repro_torch.fit`` trains with the requested engine composition,
2. the model is compacted to its support vectors (``compact_support``),
3. the SV block is padded to the decision kernel's pack geometry and its
   row norms precomputed,

and every later request for the same (spec, data, precision, fit-kwargs)
key gets the prepared ``ServingModel`` back without touching the solver.
Keys use a content fingerprint of X (sampled above ``_HASH_SAMPLE_BYTES``),
never object identity.

``precision`` is threaded through both the fit and the pack: the support
block is stored in the serving tile dtype ONCE here; norms are f32 of the
rounded rows. The cache is thread-safe; concurrent misses on the same key
coalesce onto one fit (per-key in-flight locks).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, compact_support,
                                     concrete_spec, with_quantile_offsets)
from repro_torch.kernels.precision import check_precision, tile_dtype
from repro_torch.kernels.tiling import LANE

Tensor = torch.Tensor

# Fingerprint at most this many bytes of X: above it, hash an evenly
# strided row sample plus the exact shape/dtype.
_HASH_SAMPLE_BYTES = 1 << 24


@dataclasses.dataclass
class ServingModel:
    """A fitted slab packed for the decision kernel, ready to score.

    ``model`` is the compacted reference (support rows only) whose
    ``decision_function`` the scorer must match (within the documented
    precision tolerance below f32); ``t_pad`` / ``gamma_pad`` /
    ``t_norms`` are the kernel operands, padded once to a multiple of
    ``tn`` rows and 128 features (zero-gamma padding rows contribute
    nothing, so a zero-SV model still serves). ``t_pad`` is stored in the
    serving tile dtype; gamma and the norms are always f32. All of them
    live on the device the model was fitted on.
    """

    model: OCSSVMModel
    t_pad: Tensor       # (M_pad, d_pad) support rows, serving tile dtype
    gamma_pad: Tensor   # (M_pad, 1) f32, zero beyond n_sv
    t_norms: Tensor     # (M_pad, 1) f32 precomputed ||t||^2 (rounded rows)
    n_sv: int
    tn: int
    spec: SlabSpec      # concretized (hashable) spec
    precision: str = "f32"
    fit_iters: int = 0
    # The solver state behind the model (an ``engine.SolverArtifact``):
    # ``get_or_fit(warm_start=served.artifact)`` re-fits warm from it.
    artifact: Optional[object] = dataclasses.field(default=None, repr=False)
    _scorer: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def rho1(self) -> Tensor:
        return self.model.rho1

    @property
    def rho2(self) -> Tensor:
        return self.model.rho2

    @property
    def d(self) -> int:
        return int(self.model.X.shape[1])

    def scorer(self, **kwargs):
        """The batched scoring engine for this model.

        No kwargs -> one memoized default ``BatchScorer`` (so repeated
        ``score`` calls share it); with kwargs a fresh scorer is built
        (e.g. ``mesh=...`` for the sharded path).
        """
        from repro_torch.serve.scorer import BatchScorer
        if kwargs:
            return BatchScorer(self, **kwargs)
        if self._scorer is None:
            self._scorer = BatchScorer(self)
        return self._scorer

    def score(self, q, **kwargs):
        """Slab decision values for queries (n, d) -> (n,)."""
        return self.scorer(**kwargs).score(q)

    def predict(self, q, **kwargs):
        """+1 inside the slab, -1 outside (numpy in, numpy out)."""
        s = self.score(q, **kwargs)
        if isinstance(s, np.ndarray):
            return np.where(s >= 0, 1, -1)
        return torch.where(s >= 0, 1, -1)


def pack_model(model: OCSSVMModel, *, sv_threshold: float = 1e-7,
               tn: int = 512, precision: str = "f32") -> ServingModel:
    """Compact a fitted model to SVs and pack it for ``decision_packed``.

    Rows are padded to a multiple of ``tn`` (at least one tile) and
    features to 128, as the JAX package packs them; the SV block is cast
    to the serving dtype HERE, once, and the f32 norms are computed from
    the rounded rows.
    """
    check_precision(precision)
    spec = concrete_spec(model.spec)
    compact = compact_support(model._replace(spec=spec),
                              threshold=sv_threshold)
    n_sv, d = compact.X.shape
    dev = compact.X.device
    rows = max(tn, -(-n_sv // tn) * tn)
    cols = -(-d // LANE) * LANE
    t = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    t[:n_sv, :d] = compact.X.to(torch.float32)
    t_pad = t.to(tile_dtype(precision))
    tf = t_pad.to(torch.float32)
    t_norms = torch.sum(tf * tf, dim=-1, keepdim=True)
    gamma_pad = torch.zeros((rows, 1), dtype=torch.float32, device=dev)
    gamma_pad[:n_sv, 0] = compact.gamma.to(torch.float32)
    return ServingModel(model=compact, t_pad=t_pad, gamma_pad=gamma_pad,
                        t_norms=t_norms, n_sv=int(n_sv), tn=tn, spec=spec,
                        precision=precision)


def _host_array(X) -> Tuple[np.ndarray, str]:
    """(host array, dtype name); a tensor and the numpy array of the same
    contents give the same pair."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu()
        if X.dtype == torch.bfloat16:   # numpy has no bfloat16: hash bits
            return X.view(torch.int16).numpy(), "bfloat16"
        X = X.numpy()
    a = np.asarray(X)
    return a, str(a.dtype)


def fingerprint_array(X) -> Tuple:
    """Content key for a training set: (shape, dtype, sha1 of a sample).

    Layout-invariant (``tobytes()`` serializes the logical C-order
    contents); above ``_HASH_SAMPLE_BYTES`` an evenly strided leading-axis
    sample is hashed, with ``stride = ceil(nbytes / budget)``.
    """
    a, dtype = _host_array(X)
    sample = a
    if a.ndim >= 1 and a.nbytes > _HASH_SAMPLE_BYTES:
        stride = -(-a.nbytes // _HASH_SAMPLE_BYTES)   # ceil division
        sample = a[::stride]
    digest = hashlib.sha1(sample.tobytes()).hexdigest()
    return (tuple(a.shape), dtype, digest)


class ExtendableFingerprint:
    """Incremental ``fingerprint_array``: O(delta rows) keying for appends.

    sha1 is a streaming hash, so while the WHOLE array is hashed (nbytes
    within ``_HASH_SAMPLE_BYTES``; above it ``fingerprint_array`` hashes a
    strided sample and the prefix property breaks), hashing appended rows
    into a copy of the saved sha1 state gives exactly
    ``fingerprint_array(concat([X, X_app]))``. Tensors hash as
    ``fingerprint_array`` hashes them (bf16 as its bits, named
    "bfloat16"), so the keys equal the JAX package's for the same rows.

    ``extend`` returns the extended fingerprint, or None when only a full
    re-hash can be exact (sampled regime, dtype or width mismatch).
    """

    __slots__ = ("shape", "dtype", "nbytes", "_h", "_key")

    def __init__(self, X):
        a, self.dtype = _host_array(X)
        self.shape = tuple(a.shape)
        self.nbytes = a.nbytes
        self._h = (hashlib.sha1(a.tobytes())
                   if a.ndim >= 1 and a.nbytes <= _HASH_SAMPLE_BYTES
                   else None)
        # hexdigest() does not finalize: _h stays extendable.
        self._key = ((self.shape, self.dtype, self._h.hexdigest())
                     if self._h is not None else fingerprint_array(X))

    @property
    def key(self) -> Tuple:
        """== ``fingerprint_array`` of the array this fingerprint covers."""
        return self._key

    def extend(self, X_app) -> Optional["ExtendableFingerprint"]:
        """Fingerprint of ``concat([X, X_app], axis=0)``, hashing only
        ``X_app`` — or None when only a full re-hash can be exact."""
        a, dtype = _host_array(X_app)
        if (self._h is None or dtype != self.dtype
                or tuple(a.shape[1:]) != self.shape[1:]
                or self.nbytes + a.nbytes > _HASH_SAMPLE_BYTES):
            return None
        out = object.__new__(ExtendableFingerprint)
        out.shape = (self.shape[0] + a.shape[0],) + self.shape[1:]
        out.dtype = self.dtype
        out.nbytes = self.nbytes + a.nbytes
        out._h = self._h.copy()
        out._h.update(a.tobytes())
        out._key = (out.shape, out.dtype, out._h.hexdigest())
        return out


def spec_key(spec: SlabSpec) -> Tuple:
    spec = concrete_spec(spec)
    k = spec.kernel
    return (spec.nu1, spec.nu2, spec.eps, k.name, k.gamma, k.coef0,
            k.degree)


def _kwarg_key(v) -> Tuple:
    """Hashable key for one fit kwarg; arrays are content-fingerprinted
    (their repr truncates and would collide)."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return ("array",) + fingerprint_array(v)
    return ("repr", repr(v))


def recipe_key(X, spec: Optional[SlabSpec] = None, *,
               offsets: str = "paper", sv_threshold: float = 1e-7,
               tn: int = 512, precision: str = "f32",
               _fingerprint: Optional[Tuple] = None,
               **fit_kwargs) -> Tuple:
    """The full cache key for one serve recipe: the concretized spec, the
    data fingerprint, the offset policy, the pack shape, the precision,
    and every fit kwarg. The registry uses the same tuple as recipe
    identity, so "same recipe" means "same cache entry".

    ``_fingerprint`` substitutes a precomputed data fingerprint (an
    ``ExtendableFingerprint.key``) for ``fingerprint_array(X)``; it MUST
    equal what ``fingerprint_array`` would return.
    """
    if spec is None:
        spec = SlabSpec()
    if offsets not in ("paper", "quantile"):
        raise ValueError(f"unknown offsets {offsets!r}; "
                         "expected 'paper' or 'quantile'")
    check_precision(precision)
    fp = fingerprint_array(X) if _fingerprint is None else _fingerprint
    return (spec_key(spec), fp, offsets, sv_threshold,
            tn, precision,
            tuple(sorted((k, _kwarg_key(v)) for k, v in
                         fit_kwargs.items())))


class _InFlight:
    """One in-progress fit: losers of the miss race block on ``done``."""

    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result: Optional[ServingModel] = None
        self.exc: Optional[BaseException] = None


class ModelCache:
    """LRU warm-model cache keyed on ``recipe_key``.

    ``get_or_fit`` is the entry point; misses fit + pack, hits return the
    prepared ``ServingModel`` (with its memoized scorer). Concurrent
    misses on the SAME key coalesce: the first caller runs the fit, later
    callers block on its in-flight entry and get the same model (counted
    as hits). If the fit raises, waiters retry the race so the next caller
    becomes the fitter instead of caching the failure.
    """

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: OrderedDict = OrderedDict()
        self._inflight: dict = {}
        self._gen = 0           # bumped by clear(): stale fits don't insert
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: Tuple) -> Optional[ServingModel]:
        """Warm-path getter by precomputed ``recipe_key``: the cached
        model (counted as a hit, LRU recency refreshed) or None. A miss
        counts nothing; callers fall back to ``get_or_fit``."""
        with self._lock:
            served = self._entries.get(key)
            if served is not None:
                self.hits += 1
                self._entries.move_to_end(key)
            return served

    def evict(self, key: Tuple) -> bool:
        """Drop one entry by its ``recipe_key``; True iff it was cached.
        A fit in flight for the key is not cancelled, and models handed
        out earlier stay valid."""
        with self._lock:
            return self._entries.pop(key, None) is not None

    def clear(self) -> None:
        """Empty the cache and counters. Fits in flight complete into the
        pre-clear generation: their waiters get a model, and nothing
        re-appears in the cleared cache."""
        with self._lock:
            self._entries.clear()
            self._inflight.clear()
            self._gen += 1
            self.hits = 0
            self.misses = 0

    def get_or_fit(self, X, spec: Optional[SlabSpec] = None, *,
                   offsets: str = "paper", sv_threshold: float = 1e-7,
                   tn: int = 512, precision: str = "f32",
                   warm_start=None, warm_stats_out: Optional[dict] = None,
                   _key: Optional[Tuple] = None,
                   **fit_kwargs) -> ServingModel:
        """Return a warm ``ServingModel``, fitting on miss.

        offsets: "paper" keeps the solver's margin-SV rho recovery;
        "quantile" applies ``with_quantile_offsets`` before compaction.
        precision: forwarded to ``fit`` AND used to pack the support
        block; part of the key. Extra kwargs flow to ``fit`` and take
        part in the key.

        ``warm_start`` (a ``SolverArtifact`` from an earlier fit — e.g.
        ``served.artifact`` — or an ``SMOResult``) routes a miss through
        ``fit_update``. It is NOT part of the key: the seed changes how
        fast the optimum is reached, not (within tolerance) which model
        comes out. ``warm_stats_out`` receives ``fit_update``'s overlap /
        mode stats when the warm path fits. ``_key`` substitutes a
        precomputed ``recipe_key`` (the registry's delta-refresh keying).
        """
        if spec is None:
            spec = SlabSpec()
        key = _key if _key is not None else recipe_key(
            X, spec, offsets=offsets, sv_threshold=sv_threshold, tn=tn,
            precision=precision, **fit_kwargs)

        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return self._entries[key]
                flight = self._inflight.get(key)
                if flight is None:
                    flight = self._inflight[key] = _InFlight()
                    self.misses += 1
                    gen = self._gen
                    break   # this thread owns the fit
            flight.done.wait()
            if flight.exc is None and flight.result is not None:
                with self._lock:
                    self.hits += 1
                return flight.result
            # the fitter failed: loop and race to become the next fitter

        try:
            from repro_torch.api import fit, fit_update
            from repro_torch.core.engine.state import artifact_from_result
            if warm_start is not None:
                res = fit_update(warm_start, X, spec, precision=precision,
                                 stats_out=warm_stats_out, **fit_kwargs)
            else:
                res = fit(X, spec, precision=precision, **fit_kwargs)
            model = res.model
            if offsets == "quantile":
                model = with_quantile_offsets(model)
            served = pack_model(model, sv_threshold=sv_threshold, tn=tn,
                                precision=precision)
            served.fit_iters = int(res.iters)
            served.artifact = artifact_from_result(res, precision=precision)
        except BaseException as e:
            with self._lock:
                if self._inflight.get(key) is flight:
                    self._inflight.pop(key)
            flight.exc = e
            flight.done.set()
            raise

        with self._lock:
            if self._gen == gen:   # clear() since the miss -> don't insert
                self._entries[key] = served
                self._entries.move_to_end(key)
                while len(self._entries) > self.maxsize:
                    self._entries.popitem(last=False)
            if self._inflight.get(key) is flight:
                self._inflight.pop(key)
        flight.result = served
        flight.done.set()
        return served


_DEFAULT_CACHE = ModelCache()


def default_cache() -> ModelCache:
    """The process-wide cache behind ``repro_torch.serve(...)``."""
    return _DEFAULT_CACHE


def serve(X, spec: Optional[SlabSpec] = None, *,
          cache: Optional[ModelCache] = None, **kwargs) -> ServingModel:
    """Train-then-serve: a warm ``ServingModel``. kwargs flow to
    ``ModelCache.get_or_fit`` (offsets/sv_threshold/tn/precision) and on
    to ``fit`` (strategy, gram_mode, device, tol, P, ...)."""
    if cache is None:   # not `or`: an empty cache is len()==0 falsy
        cache = _DEFAULT_CACHE
    return cache.get_or_fit(X, spec, **kwargs)

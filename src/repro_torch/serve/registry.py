"""Multi-model serving registry: name -> recipe -> warm ``ServingModel``.

A fast SMO makes a slab model cheap enough that the natural serving unit
is a *fleet* of them — one per tenant, stream, or feature view. The
registry is the name layer of that fleet:

* operators ``register`` a **recipe** — training data + ``SlabSpec`` +
  serve kwargs (precision, offsets, fit kwargs, device) + an optional
  per-model admission ``quota`` — without paying for a fit;
* callers route by name: ``get(name)`` fits on first use through the
  warm ``ModelCache`` and returns the packed ``ServingModel`` on every
  later call. Recipe identity IS the cache key
  (``model_cache.recipe_key``), so the cache's per-key in-flight locks
  give the registry its concurrency story: N threads racing on a
  recipe'd name run exactly one fit;
* ``evict`` / ``refresh`` are the lifecycle hooks: evict drops the
  cached model (the next ``get`` re-fits), refresh does it eagerly and
  hands back the re-fitted model. Models already handed out keep
  scoring — eviction forgets a reference, it never mutates a model.

``refresh`` is the streaming hook: called with ``append=`` (new rows for
the same name) it updates the recipe in place — same quota, same serve
kwargs, recipe key re-derived in O(delta m) through an
``ExtendableFingerprint`` — and routes the re-fit through the cached
model's ``SolverArtifact`` as a warm delta-solve (``fit_update``). The
warm route is gated by the score-distribution drift detector
(``repro_torch.serve.drift``): appended rows that score far from the
cached slab force a full cold refit instead. Every refresh records which
way it went in the per-model ``refresh_modes`` counters.

The registry owns *names and recipes only*. Admission — quota
enforcement, deadline-aware window flushing — lives in
``repro_torch.serve.admission`` and reads the per-model ``quota``
recorded here.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ocssvm import SlabSpec
from repro_torch.serve.drift import DEFAULT_THRESHOLD, DriftReport, score_drift
from repro_torch.serve.model_cache import (ExtendableFingerprint, ModelCache,
                                           ServingModel, recipe_key)


class RegistryError(Exception):
    """Base of the registry's typed errors."""


class UnknownModelError(RegistryError, KeyError):
    """Routing to a name no recipe was registered under."""

    def __init__(self, name: str, known: Tuple[str, ...] = ()):
        self.name = name
        self.known = known
        super().__init__(f"no model registered as {name!r}"
                         + (f" (registered: {', '.join(known)})"
                            if known else " (registry is empty)"))


class DuplicateModelError(RegistryError, ValueError):
    """Re-registering a name with a *different* recipe without
    ``replace=True`` — the guard against silently respec'ing a tenant's
    model out from under its traffic."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(
            f"model {name!r} is already registered with a different "
            "recipe; pass replace=True to swap it")


@dataclasses.dataclass(frozen=True)
class ModelRecipe:
    """Everything needed to (re)build one named model, fit deferred.

    ``key`` is the ``ModelCache`` entry this recipe resolves to —
    computed once at registration, reused for identity checks and
    eviction. ``quota`` is the per-model admission budget (rows a
    controller may hold queued for this name; ``None`` = unlimited) —
    recorded here, enforced by ``AdmissionController``.
    """

    name: str
    X: object
    spec: SlabSpec
    quota: Optional[int]
    serve_kwargs: Tuple[Tuple[str, object], ...]
    key: Tuple

    def kwargs(self) -> dict:
        return dict(self.serve_kwargs)


class ModelRegistry:
    """Thread-safe name -> recipe map over one warm ``ModelCache``."""

    def __init__(self, cache: Optional[ModelCache] = None):
        # not `or`: an empty cache is len()==0 falsy. When the registry
        # owns its cache it grows maxsize with the fleet (every recipe
        # is one cache key, so an LRU smaller than the fleet would turn
        # round-robin warm traffic into a fit per request).
        self._own_cache = cache is None
        self.cache = cache if cache is not None else ModelCache()
        self._recipes: Dict[str, ModelRecipe] = {}
        # Per-name lifecycle counter: bumped whenever the model behind a
        # name may change (evict/refresh/replace/unregister), never
        # reset — admission controllers compare it to know when their
        # memoized per-model services went stale.
        self._versions: Dict[str, int] = {}
        # Per-name refresh routing counters ({"warm": n, "cold": n}) and
        # the evidence behind the latest routing decision — operators
        # audit why a refresh refit cold via refresh_stats(name).
        self.refresh_modes: Dict[str, Dict[str, int]] = {}
        self._last_drift: Dict[str, Optional[DriftReport]] = {}
        self._last_warm_stats: Dict[str, Optional[dict]] = {}
        # Per-name extendable data fingerprint: lets an append-refresh
        # re-key the recipe in O(Δm) (built lazily on first append).
        self._fps: Dict[str, ExtendableFingerprint] = {}
        # RLock: register's replace path consults _key_shared under it
        self._lock = threading.RLock()

    # -- registration -------------------------------------------------------
    def register(self, name: str, X, spec: Optional[SlabSpec] = None, *,
                 quota: Optional[int] = None, replace: bool = False,
                 **serve_kwargs) -> ModelRecipe:
        """Record a recipe under ``name``; no fit happens here.

        Registering the same name with an identical recipe is an
        idempotent no-op (so routing entry points may re-register on
        every call); a *different* recipe raises ``DuplicateModelError``
        unless ``replace=True``, which also evicts the old cached model.
        ``quota=None`` on a re-register keeps the existing quota; an
        explicit quota updates it. serve_kwargs flow to
        ``ModelCache.get_or_fit`` (offsets/sv_threshold/tn/precision and
        every fit kwarg) and are part of recipe identity.
        """
        if not name:
            raise ValueError("model name must be a non-empty string")
        if quota is not None and quota < 1:
            raise ValueError(f"quota must be >= 1 rows, got {quota}")
        key = recipe_key(X, spec, **serve_kwargs)
        with self._lock:
            old = self._recipes.get(name)
            if old is not None:
                if old.key == key:
                    if quota is None or quota == old.quota:
                        return old
                    recipe = dataclasses.replace(old, quota=quota)
                    self._recipes[name] = recipe
                    return recipe
                if not replace:
                    raise DuplicateModelError(name)
                if not self._key_shared(old.key, name):
                    self.cache.evict(old.key)
                self._versions[name] = self._versions.get(name, 0) + 1
                self._fps.pop(name, None)   # new data, new fingerprint
                if quota is None:     # replace keeps the quota too
                    quota = old.quota
            recipe = ModelRecipe(
                name=name, X=X,
                spec=spec if spec is not None else SlabSpec(),
                quota=quota,
                serve_kwargs=tuple(sorted(serve_kwargs.items())), key=key)
            self._recipes[name] = recipe
            if self._own_cache and len(self._recipes) > self.cache.maxsize:
                self.cache.maxsize = len(self._recipes)
            return recipe

    def unregister(self, name: str, *, evict: bool = True) -> None:
        """Forget ``name`` (and by default its cached model — unless
        another registered name shares the identical recipe, whose warm
        model must survive)."""
        recipe = self._recipe(name)
        with self._lock:
            self._recipes.pop(name, None)
        if evict and not self._key_shared(recipe.key, name):
            self.cache.evict(recipe.key)
        with self._lock:
            self._versions[name] = self._versions.get(name, 0) + 1
            self._fps.pop(name, None)
            self.refresh_modes.pop(name, None)
            self._last_drift.pop(name, None)
            self._last_warm_stats.pop(name, None)

    # -- routing ------------------------------------------------------------
    def get(self, name: str) -> ServingModel:
        """The warm model for ``name`` — fit-on-first-use via the cache.

        Concurrent first requests coalesce onto one fit through the
        cache's per-key in-flight locks; every later call is a cache hit
        returning the same packed model (and its memoized scorer with
        the already-compiled bucket executables). Warm hits go through
        the precomputed ``recipe.key`` — no per-lookup re-fingerprint
        of the training data.
        """
        recipe = self._recipe(name)
        served = self.cache.lookup(recipe.key)
        if served is not None:
            return served
        return self.cache.get_or_fit(recipe.X, recipe.spec,
                                     **recipe.kwargs())

    def recipe(self, name: str) -> ModelRecipe:
        return self._recipe(name)

    def quota(self, name: str) -> Optional[int]:
        """Per-model admission quota in rows (None = unlimited)."""
        return self._recipe(name).quota

    def set_quota(self, name: str, quota: Optional[int]) -> ModelRecipe:
        """Update the admission quota of an already registered name
        (``None`` lifts it). Quota is operational state, not recipe
        identity — no refit, no version bump."""
        if quota is not None and quota < 1:
            raise ValueError(f"quota must be >= 1 rows, got {quota}")
        with self._lock:
            recipe = self._recipes.get(name)
            if recipe is None:
                raise UnknownModelError(name, tuple(sorted(self._recipes)))
            recipe = dataclasses.replace(recipe, quota=quota)
            self._recipes[name] = recipe
            return recipe

    # -- lifecycle hooks ----------------------------------------------------
    def _key_shared(self, key: Tuple, excluding: str) -> bool:
        """Another registered name resolves to the same cache entry?"""
        with self._lock:
            return any(r.key == key for n, r in self._recipes.items()
                       if n != excluding)

    def evict(self, name: str) -> bool:
        """Drop ``name``'s cached model; the recipe stays and the next
        ``get`` re-fits. True iff a model was dropped. In-flight scores
        against the old model object are unaffected — they hold their
        own reference.

        When another name shares the identical recipe the cache entry
        is NOT dropped (identical recipe == identical model by
        construction, and cold-starting the other name would buy
        nothing); the version still bumps so consumers re-resolve.
        The version bump happens AFTER the cache eviction — a consumer
        racing in between memoizes (old model, old version) at worst,
        which the bump then invalidates; the reverse order could pin
        (old model, new version) forever.
        """
        recipe = self._recipe(name)
        dropped = False
        if not self._key_shared(recipe.key, name):
            dropped = self.cache.evict(recipe.key)
        with self._lock:
            self._versions[name] = self._versions.get(name, 0) + 1
        return dropped

    def version(self, name: str) -> int:
        """Lifecycle counter for ``name`` — changes whenever the model a
        ``get`` would return may differ from earlier (evict, refresh,
        replace, unregister). Consumers that memoize per-model state
        (the admission controller's services) rebuild when it moves."""
        with self._lock:
            return self._versions.get(name, 0)

    def refresh(self, name: str, append=None, *, X=None,
                mode: str = "auto",
                drift_threshold: float = DEFAULT_THRESHOLD) -> ServingModel:
        """Re-fit ``name`` now — warm delta-solve by default; returns
        the fresh model.

        ``append`` adds rows to the recipe's training set (cast to its
        dtype); ``X`` replaces the set outright; neither re-fits on the
        recipe's current data. Either way the recipe is updated in
        place — same name, same ``quota``, same serve kwargs — and the
        admission state layered on top (open windows, observed bucket
        latencies) survives the version bump untouched. Append-refresh
        re-keys the recipe in O(Δm): the cached
        ``ExtendableFingerprint`` hashes only the appended rows.

        Routing: when the cached model carries a ``SolverArtifact``,
        ``mode="auto"`` runs the score-distribution drift detector on
        the candidate set and warm-starts the re-fit from the artifact
        (``fit_update`` through the cache) unless it drifted past
        ``drift_threshold`` — then, and for ``mode="cold"`` or a
        missing artifact, the re-fit runs cold. ``mode="warm"`` skips
        the detector. The decision lands in ``refresh_modes[name]``
        and ``refresh_stats(name)``.
        """
        if mode not in ("auto", "warm", "cold"):
            raise ValueError(f"unknown refresh mode {mode!r}; "
                             "expected 'auto', 'warm' or 'cold'")
        if append is not None and X is not None:
            raise ValueError("pass append= (delta rows) or X= (full "
                             "replacement), not both")
        recipe = self._recipe(name)
        old_key = recipe.key

        fp_new = None
        if append is not None:
            base = recipe.X
            if not isinstance(base, torch.Tensor):
                base = np.asarray(base)
            app = _rows_like(base, append)
            if app.ndim != base.ndim \
                    or tuple(app.shape[1:]) != tuple(base.shape[1:]):
                raise ValueError(
                    f"append rows {tuple(app.shape)} do not extend the "
                    f"recipe's training set {tuple(base.shape)}")
            X_new = (torch.cat([base, app]) if isinstance(base, torch.Tensor)
                     else np.concatenate([base, app]))
            with self._lock:
                fp_old = self._fps.get(name)
            if fp_old is None or fp_old.shape != tuple(base.shape):
                fp_old = ExtendableFingerprint(base)   # first append: O(m)
            fp_new = fp_old.extend(app)                # O(Δm) from here on
            if fp_new is None:                         # sampled regime
                fp_new = ExtendableFingerprint(X_new)
        elif X is not None:
            X_new = X
            fp_new = ExtendableFingerprint(X_new)
        else:
            X_new = recipe.X

        new_key = old_key if fp_new is None else recipe_key(
            X_new, recipe.spec, _fingerprint=fp_new.key, **recipe.kwargs())

        # The warm seed is the OLD entry's artifact — read it before the
        # eviction below forgets the entry.
        prev = self.cache.lookup(old_key)
        artifact = getattr(prev, "artifact", None)

        report = None
        route = mode
        if artifact is None:
            route = "cold"
        elif mode == "auto":
            # For an append, test the appended rows alone: a strided
            # sample of the full set would dilute a small shifted delta
            # below any threshold. What is new is what can have drifted.
            cand = app if append is not None else X_new
            report = score_drift(artifact, cand, threshold=drift_threshold,
                                 device=recipe.kwargs().get("device"))
            route = "cold" if report.drifted else "warm"

        with self._lock:
            self._recipes[name] = recipe = dataclasses.replace(
                recipe, X=X_new, key=new_key)
            if fp_new is not None:
                self._fps[name] = fp_new
        # Same ordering contract as evict(): drop the entry, THEN bump —
        # a consumer racing in between memoizes (old model, old version)
        # at worst, which the bump invalidates.
        if not self._key_shared(old_key, name):
            self.cache.evict(old_key)
        with self._lock:
            self._versions[name] = self._versions.get(name, 0) + 1

        warm_stats: Optional[dict] = {} if route == "warm" else None
        served = self.cache.get_or_fit(
            X_new, recipe.spec,
            warm_start=artifact if route == "warm" else None,
            warm_stats_out=warm_stats, _key=new_key, **recipe.kwargs())
        # fit_update falls back cold below its overlap floor — count
        # what actually ran, not what the gate asked for.
        if warm_stats and warm_stats.get("mode") == "cold":
            route = "cold"
        with self._lock:
            counts = self.refresh_modes.setdefault(
                name, {"warm": 0, "cold": 0})
            counts[route] += 1
            self._last_drift[name] = report
            self._last_warm_stats[name] = warm_stats
        return served

    def refresh_stats(self, name: str) -> dict:
        """How this name's refreshes were routed: the ``refresh_modes``
        counters plus the latest drift report and warm-solve stats."""
        self._recipe(name)                  # typed error for unknown names
        with self._lock:
            return {
                "modes": dict(self.refresh_modes.get(
                    name, {"warm": 0, "cold": 0})),
                "last_drift": self._last_drift.get(name),
                "last_warm": self._last_warm_stats.get(name),
            }

    # -- introspection ------------------------------------------------------
    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._recipes))

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._recipes

    def __len__(self) -> int:
        with self._lock:
            return len(self._recipes)

    def _recipe(self, name: str) -> ModelRecipe:
        with self._lock:
            recipe = self._recipes.get(name)
        if recipe is None:
            raise UnknownModelError(name, self.names())
        return recipe


def _rows_like(base, rows):
    """``rows`` in ``base``'s container, dtype (and device, for a
    tensor): the appended rows of a refresh."""
    if isinstance(base, torch.Tensor):
        rows = rows if isinstance(rows, torch.Tensor) \
            else torch.as_tensor(np.asarray(rows))
        return rows.detach().to(device=base.device, dtype=base.dtype)
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu()
        rows = (rows.float() if rows.dtype == torch.bfloat16
                else rows).numpy()
    return np.asarray(rows, base.dtype)


_DEFAULT_REGISTRY = ModelRegistry()


def default_registry() -> ModelRegistry:
    """The process-wide registry behind ``repro_torch.serve(...,
    model=...)``. It wraps its own ``ModelCache``, separate from
    ``model_cache.default_cache()``: registry traffic and anonymous
    ``repro_torch.serve(X, spec)`` traffic never evict each other.
    """
    return _DEFAULT_REGISTRY


def serve(X=None, spec: Optional[SlabSpec] = None, *,
          model: Optional[str] = None,
          registry: Optional[ModelRegistry] = None,
          quota: Optional[int] = None, **kwargs):
    """Routed ``repro_torch.serve``: by name through a registry, or
    anonymous.

    * ``serve(X, spec)`` — warm-cache train-then-serve (kwargs may include
      ``cache=``).
    * ``serve(X, spec, model="tenant-a")`` — register-or-route: records
      the recipe under the name on first call (idempotent afterwards;
      a *different* recipe under the same name raises
      ``DuplicateModelError``) and returns the registry's warm model.
    * ``serve(model="tenant-a")`` — pure routing to an already
      registered name (``UnknownModelError`` if absent); ``quota=``
      updates the registered recipe's quota, and passing spec/fit
      kwargs here is an error rather than a silent drop (they only
      mean something with ``X``).
    """
    if model is None:
        if X is None:
            raise TypeError("serve() needs X, or model= to route by name")
        if registry is not None or quota is not None:
            raise TypeError("registry=/quota= only apply with model=")
        from repro_torch.serve.model_cache import serve as cache_serve
        return cache_serve(X, spec, **kwargs)
    if "cache" in kwargs:
        raise TypeError("cache= does not apply with model=: the "
                        "registry owns its cache (pass registry=)")
    reg = registry if registry is not None else _DEFAULT_REGISTRY
    if X is not None:
        reg.register(model, X, spec, quota=quota, **kwargs)
        return reg.get(model)
    if spec is not None or kwargs:
        raise TypeError("spec/fit kwargs need X: without data this is a "
                        "pure name lookup, and dropping them silently "
                        "would hide a mis-specified recipe")
    if quota is not None:
        reg.set_quota(model, quota)
    return reg.get(model)

"""repro_torch.serve — the serving subsystem: train-then-serve, one
composition, as in the JAX package's ``repro.serve``.

* ``model_cache`` — warm-model cache keyed on (SlabSpec, data
  fingerprint); a miss fits via ``repro_torch.fit`` and packs the support
  set for the decision kernel once (``ServingModel``).
* ``scorer``      — ``BatchScorer``: padding buckets (64/256/1024/4096)
  over the ``decision`` CUDA kernel; ``mesh=`` shards the queries over
  a mesh's ranks.
* ``service``     — ``ScoringService``: micro-batching request loop with
  per-bucket latency/throughput counters on an injectable clock.
* ``registry``    — ``ModelRegistry``: name -> recipe -> warm model
  routing over the cache, with per-model admission quotas and
  drift-gated streaming ``refresh`` (``drift`` holds the KS detector).
* ``admission``   — ``AdmissionController``: deadline-aware coalescing
  windows in front of ``ScoringService.flush``, typed quota rejection.
* ``async_driver``— ``AsyncDriver``: the background driver thread that
  wakes on the earliest pending deadline and polls, plus the
  ``serve_async`` coroutine front door.
* ``shm_registry``— cross-process fleet: packed models published to
  ``multiprocessing.shared_memory`` (refcounted, liveness-pruned) so N
  workers attach — bitwise-identically — to one warm fleet; segments
  attach across the two packages.

The package itself is callable — ``repro_torch.serve(X, spec)`` returns a
warm ``ServingModel`` from the default cache, and ``repro_torch.serve(X,
spec, model="tenant-a")`` routes through the default registry — so the
one-line entry point and the subsystem share a single name (see
``_CallableModule``).
"""
from __future__ import annotations

import sys as _sys
import types as _types

from repro_torch.serve.model_cache import (ExtendableFingerprint, ModelCache,
                                           ServingModel, default_cache,
                                           fingerprint_array, pack_model,
                                           recipe_key, spec_key)
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionHandle, QuotaExceededError)
from repro_torch.serve.async_driver import (AsyncDriver, DriverCrashed,
                                            default_driver,
                                            reset_default_driver,
                                            serve_async)
from repro_torch.serve.shm_registry import (ShmKeyError, ShmLease, attach,
                                            attach_or_publish, live_refs,
                                            publish)
from repro_torch.serve.drift import DriftReport, ks_statistic, score_drift
from repro_torch.serve.registry import (DuplicateModelError, ModelRecipe,
                                        ModelRegistry, RegistryError,
                                        UnknownModelError, default_registry,
                                        serve)
from repro_torch.serve.scorer import BUCKETS, BatchScorer, bucket_for
from repro_torch.serve.service import (BucketStats, Pending, ScoringService,
                                       run_request_stream)

__all__ = [
    "ExtendableFingerprint", "ModelCache", "ServingModel", "default_cache",
    "fingerprint_array", "pack_model", "recipe_key", "serve", "spec_key",
    "DriftReport", "ks_statistic", "score_drift",
    "BUCKETS", "BatchScorer", "bucket_for",
    "BucketStats", "Pending", "ScoringService", "run_request_stream",
    "DuplicateModelError", "ModelRecipe", "ModelRegistry", "RegistryError",
    "UnknownModelError", "default_registry",
    "AdmissionController", "AdmissionHandle", "QuotaExceededError",
    "AsyncDriver", "DriverCrashed", "default_driver",
    "reset_default_driver", "serve_async",
    "ShmKeyError", "ShmLease", "attach", "attach_or_publish", "live_refs",
    "publish",
]


class _CallableModule(_types.ModuleType):
    """Lets ``repro_torch.serve(X, spec)`` keep working after any
    ``import repro_torch.serve.<submodule>`` binds this module object onto
    the parent package."""

    def __call__(self, X=None, spec=None, **kwargs):
        return serve(X, spec, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule

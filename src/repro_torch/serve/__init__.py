"""repro_torch.serve — train-then-serve.

* ``model_cache`` — warm-model cache keyed on (SlabSpec, data
  fingerprint); a miss fits via ``repro_torch.fit`` and packs the support
  set for the decision kernel once (``ServingModel``).
* ``scorer``      — ``BatchScorer``: padding buckets (64/256/1024/4096)
  over the ``decision`` CUDA kernel.

The package itself is callable — ``repro_torch.serve(X, spec)`` returns a
warm ``ServingModel`` from the default cache — so the one-line entry
point and the subsystem share a single name (see ``_CallableModule``).
"""
from __future__ import annotations

import sys as _sys
import types as _types

from repro_torch.serve.model_cache import (ModelCache, ServingModel,
                                           default_cache, fingerprint_array,
                                           pack_model, recipe_key, spec_key)
from repro_torch.serve.scorer import BUCKETS, BatchScorer, bucket_for

__all__ = [
    "ModelCache", "ServingModel", "default_cache", "fingerprint_array",
    "pack_model", "recipe_key", "spec_key",
    "BUCKETS", "BatchScorer", "bucket_for",
]


class _CallableModule(_types.ModuleType):
    """Lets ``repro_torch.serve(X, spec)`` keep working after any
    ``import repro_torch.serve.<submodule>`` binds this module object onto
    the parent package."""

    def __call__(self, X=None, spec=None, **kwargs):
        from repro_torch.api import serve
        return serve(X, spec, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule

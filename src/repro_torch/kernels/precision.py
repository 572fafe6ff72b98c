"""Mixed-precision policy for the hand-written kernels.

The ``fupdate`` and ``decision`` kernels read their data tiles (the
training rows, the selected block, the queries, the support set) in the
precision the caller asks for and do everything else in f32:

* tile inputs are cast to the 16-bit dtype **once**, outside the kernel,
  so the stream itself is 16-bit; the kernel widens each element with
  ``__bfloat162float`` / ``__half2float``;
* every dot product accumulates in f32 FMA (no TF32 anywhere);
* norms are computed in f32 **from the rounded values**, so the RBF
  distance ``||x||^2 + ||y||^2 - 2 x.y`` is the squared distance of the
  rounded points;
* the epilogue (RBF exp, poly powers, the slab rho comparisons) and the
  f-cache / gamma / decision outputs stay f32.

``precision="f32"`` is the default and is a no-op cast.
"""
from __future__ import annotations

import numpy as np
import torch

# Public knob values, in "fastest-safe first" documentation order.
PRECISIONS = ("f32", "bf16", "f16")

_TILE_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
}

# Low-precision-vs-f32-truth tolerances, the same numbers the JAX package
# documents: ``rtol`` element-wise, plus ``atol`` scaled by the OUTPUT
# magnitude (max |truth|, floored at 1). bf16 keeps ~2 significant
# digits (2^-8 ulp), f16 ~3 (2^-11); f32 differences are
# accumulation-order only.
TOLERANCES = {
    "f32": dict(rtol=2e-4, atol=2e-4),
    "bf16": dict(rtol=4e-2, atol=2e-2),
    "f16": dict(rtol=6e-3, atol=3e-3),
}


def truth_tolerance(precision: str, truth) -> dict:
    """assert_allclose kwargs for comparing a ``precision`` output against
    f32 truth, with atol scaled to the output magnitude (see TOLERANCES)."""
    t = TOLERANCES[check_precision(precision)]
    if isinstance(truth, torch.Tensor):
        truth = truth.detach().float().cpu().numpy()
    scale = max(1.0, float(np.max(np.abs(np.asarray(truth, np.float32)))))
    return dict(rtol=t["rtol"], atol=t["atol"] * scale)


def check_precision(precision: str) -> str:
    if precision not in _TILE_DTYPES:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    return precision


def parse_precisions(spec: str) -> tuple:
    """Parse a CLI comma list ("f32,bf16") into validated precisions.

    Empty/whitespace entries are dropped; an empty spec yields ("f32",)
    so benchmark flags always have a well-defined default.
    """
    out = tuple(check_precision(p.strip()) for p in spec.split(",")
                if p.strip())
    return out or ("f32",)


def tile_dtype(precision: str) -> torch.dtype:
    """The dtype tile inputs are streamed in."""
    return _TILE_DTYPES[check_precision(precision)]


def precision_of(dtype: torch.dtype) -> str:
    """The precision whose tile dtype is ``dtype`` (of prepared rows)."""
    for name, dt in _TILE_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no precision streams {dtype}; expected one of "
                     f"{tuple(_TILE_DTYPES.values())}")


def round_to_tile(a: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 -> tile dtype round-trip, back in f32 (round to nearest even,
    as the JAX package rounds). No-op cast for "f32"."""
    if precision == "f32":
        return a.to(torch.float32)
    return a.to(torch.float32).to(tile_dtype(precision)).to(torch.float32)

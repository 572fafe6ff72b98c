"""Three-term roofline model of one NVIDIA H100 SXM card.

Terms (seconds):
    compute    = FLOPs / (chips * peak FLOP/s of the input type)
    memory     = HBM bytes / (chips * 3.35e12)
    collective = link bytes / (chips * 450e9)     [NVLink, each way]

The peaks are NVIDIA's data-sheet numbers for the SXM part, dense, at its
700 W limit: 67 TFLOP/s in f32 outside the tensor cores, 989 TFLOP/s in
bf16 and f16 on the tensor cores. A card set below 700 W runs slower under
load, so a share of these peaks is stated with the card's power limit.
The counterpart of the JAX package's ``utils/roofline.terms``, whose peaks
are a TPU's; the peak depends on the input type here, so ``terms`` takes
the precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12}


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        # overlap model: perfectly overlapped => max; report max as the bound
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
        }


def terms(flops: float, hbm_bytes: float, coll_bytes: float = 0.0,
          chips: int = 1, precision: str = "f32") -> RooflineTerms:
    """The three terms of work on ``chips`` cards whose operations take
    inputs of ``precision`` ("f32", "bf16" or "f16")."""
    if precision not in PEAK_FLOPS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {tuple(PEAK_FLOPS)}")
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS[precision]),
        memory_s=hbm_bytes / (chips * HBM_BYTES_PER_S),
        collective_s=coll_bytes / (chips * NVLINK_BYTES_PER_S),
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes, chips=chips)

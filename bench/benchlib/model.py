"""The served slab and the query rows, drawn on the device from the seed.

A configuration names the width ``d``, the support rows, the training
rows behind them, the spec and the kernel width. From the seed, in a few
large calls on the device (``torch.Generator`` there):

* support rows N(0, 1) a feature (standardized features, for which the
  kernel width 1/d is scikit-learn's ``gamma="scale"``), drawn in the
  type they are served in;
* dual coefficients inside the spec's box: a share at the upper bound's
  side 1/(nu1 m), the rest at the lower bound's -eps/(nu2 m), each
  between half and 0.95 of its bound, scaled so that they sum to
  1 - eps; far above the program's support threshold, so packing keeps
  every row;
* query rows: in-distribution rows N(0, 1) and a share of anomalies
  N(0, s^2) a feature (the configuration's ``anomaly_share`` and
  ``anomaly_scale``);
* the offsets rho1 < rho2: the 2% and 98% quantiles of s over the first
  in-distribution rows of a further draw, so both signs of the decision
  occur.

The work is the same on every seed: only the values move.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from reference.slab import raw_scores

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Rows of the sample that places the offsets.
RHO_SAMPLE = 1024


@dataclass
class Slab:
    """The benchmark's own copy of the model, from which both the program
    (through its packing) and the reference take their inputs."""

    t: torch.Tensor        # (support, d) support rows, served type
    gamma: torch.Tensor    # (support,) f32
    rho1: float
    rho2: float
    kgamma: float
    precision: str


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def draw_queries(g: torch.Generator, rows: int, config: dict,
                 device: torch.device) -> torch.Tensor:
    """(rows, d) f32 query rows: in-distribution, with every
    ``1/anomaly_share``-th row an anomaly."""
    d = int(config["d"])
    q = torch.randn((rows, d), generator=g, device=device)
    share = float(config["anomaly_share"])
    if share > 0:
        step = max(1, round(1.0 / share))
        q[::step] *= float(config["anomaly_scale"])
    return q


def draw_slab(g: torch.Generator, config: dict,
              device: torch.device) -> Slab:
    n, d = int(config["support_rows"]), int(config["d"])
    spec = config["spec"]
    m = int(config["train_rows"])
    upper = 1.0 / (spec["nu1"] * m)
    lower = -spec["eps"] / (spec["nu2"] * m)
    total = 1.0 - spec["eps"]
    t = torch.randn((n, d), generator=g, device=device,
                    dtype=DTYPES[config["precision"]])
    # Expected sums at 0.725 of each bound: the share at the lower side
    # that makes them total 1 - eps.
    mid = 0.725
    n_neg = round((mid * n * upper - total) / (mid * (upper - lower)))
    n_neg = min(max(n_neg, 0), n - 1)
    frac = 0.5 + 0.45 * torch.rand((n,), generator=g, device=device)
    bound = torch.full((n,), upper, device=device)
    bound[:n_neg] = lower
    gamma = frac * bound
    gamma = gamma[torch.randperm(n, generator=g, device=device)]
    gamma *= total / float(gamma.sum())
    kgamma = float(config["kernel"]["gamma"])
    sample = torch.randn((RHO_SAMPLE, d), generator=g, device=device)
    s = raw_scores(sample, t, gamma, kgamma, precision="f32")
    lo, hi = torch.quantile(s, torch.tensor([0.02, 0.98], device=device,
                                            dtype=torch.float64)).tolist()
    # f32 offsets: the program holds them in f32, so both sides take
    # the same numbers.
    lo, hi = torch.tensor([lo, hi], dtype=torch.float32).tolist()
    return Slab(t=t, gamma=gamma, rho1=lo, rho2=hi,
                kgamma=kgamma, precision=config["precision"])


def serving_model(slab: Slab, config: dict):
    """The program's served model, packed by the program's own packing
    from the benchmark's rows, coefficients and offsets."""
    from repro_torch.core import SlabSpec
    from repro_torch.core.kernel_fn import KernelFn
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.serve import pack_model
    spec = config["spec"]
    k = config["kernel"]
    slab_spec = SlabSpec(nu1=spec["nu1"], nu2=spec["nu2"], eps=spec["eps"],
                         kernel=KernelFn(name=k["name"], gamma=k["gamma"]))
    dev = slab.t.device
    model = OCSSVMModel(gamma=slab.gamma,
                        rho1=torch.tensor(slab.rho1, device=dev),
                        rho2=torch.tensor(slab.rho2, device=dev),
                        X=slab.t, spec=slab_spec)
    served = pack_model(model, precision=config["precision"])
    if served.n_sv != slab.t.shape[0]:
        raise RuntimeError(f"packing kept {served.n_sv} of "
                           f"{slab.t.shape[0]} support rows")
    return served


def pool_rows(config: dict, traffic: dict) -> int:
    """Rows of the query pool: at least ``pool_bytes`` of f32 rows and
    ``pool_requests`` of the largest request, so that the requests'
    queries do not sit in the card's 50 MB L2 cache."""
    d = int(config["d"])
    largest = max(traffic["rows"])
    return max(int(traffic["pool_bytes"]) // (4 * d),
               int(traffic["pool_requests"]) * largest)


def draw(seed: int, config: dict, traffic: dict, device: torch.device):
    """(the slab, the query pool) of ``seed``, on ``device``."""
    g = generator(seed, device)
    slab = draw_slab(g, config, device)
    pool = draw_queries(g, pool_rows(config, traffic), config, device)
    return slab, pool

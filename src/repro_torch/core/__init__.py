"""repro_torch.core — the paper's contribution: OCSSVM + fast SMO training.

The blocked solver (``batched_smo.solve_blocked``) is a facade over the
engine in ``repro_torch.core.engine``; ``repro_torch.fit`` picks the
composition.
"""
from repro_torch.core import engine
from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.kernel_fn import KernelFn, linear, poly, rbf
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, compact_support,
                                     concrete_spec, dual_objective,
                                     dual_objective_matfree, feasible_init,
                                     with_quantile_offsets)

__all__ = [
    "engine", "solve_blocked", "SMOResult",
    "KernelFn", "linear", "rbf", "poly",
    "OCSSVMModel", "SlabSpec", "compact_support", "concrete_spec",
    "dual_objective", "dual_objective_matfree", "feasible_init",
    "with_quantile_offsets",
]

"""repro_torch.core — the paper's contribution: OCSSVM + fast SMO training.

Every solver (``smo.solve``, ``batched_smo.solve_blocked``,
``shrinking.solve_blocked_shrinking``, the row-sharded
``distributed_smo.solve_blocked_distributed`` and
``shrinking.solve_sharded_shrinking``) is a facade over the engine in
``repro_torch.core.engine``; ``repro_torch.fit`` picks the composition.
``qp_baseline.solve_qp`` is the generic QP the paper compares against.
"""
from repro_torch.core import engine
from repro_torch.core.batched_smo import solve_blocked
from repro_torch.core.distributed_smo import (sharded_raw_scores,
                                              solve_blocked_distributed)
from repro_torch.core.engine.types import SMOResult
from repro_torch.core.kernel_fn import KernelFn, linear, poly, rbf
from repro_torch.core.kkt import converged, n_violators, slab_margin, violation
from repro_torch.core.mcc import mcc
from repro_torch.core.ocssvm import (OCSSVMModel, SlabSpec, compact_support,
                                     concrete_spec, dual_objective,
                                     dual_objective_matfree, feasible_init,
                                     recover_rhos, with_quantile_offsets)
from repro_torch.core.qp_baseline import (QPResult, project_box_hyperplane,
                                          solve_qp)
from repro_torch.core.shrinking import (solve_blocked_shrinking,
                                        solve_sharded_shrinking)
from repro_torch.core.smo import solve as solve_smo

__all__ = [
    "engine", "solve_blocked", "solve_blocked_shrinking", "solve_smo",
    "solve_blocked_distributed", "sharded_raw_scores",
    "solve_sharded_shrinking",
    "SMOResult", "KernelFn", "linear", "rbf", "poly",
    "OCSSVMModel", "SlabSpec", "compact_support", "concrete_spec",
    "dual_objective", "dual_objective_matfree", "feasible_init",
    "recover_rhos", "slab_margin", "violation", "n_violators", "converged",
    "with_quantile_offsets", "QPResult", "project_box_hyperplane",
    "solve_qp", "mcc",
]

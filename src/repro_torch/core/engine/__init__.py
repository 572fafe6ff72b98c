"""repro_torch.core.engine — the SMO solver engine.

    SolverState ──▶ Selector.select ──▶ Selection (2P rows)
                          │                   │
                          │            provider.block (2P x 2P)
                          │                   ▼
                          │         gauss_seidel_pairs (eq. 35-39)
                          │                   │ delta (2P,)
                          ▼                   ▼
                provider.scatter     provider.apply_update
                  (gamma += )         (f += K[:, sel] @ delta —
                          │            the fupdate CUDA kernel)
                          └───────┬───────────┘
                                  ▼
                       stats_fn (rho recovery + KKT + gap)

* GramProvider (``gram.py``) — ``precomputed``, ``on_the_fly``, the
  fused ``pallas`` provider (``FusedGram``; ``PallasGram`` is the
  reference's name for it) and ``sharded``
  (``ShardedGram``: a rank's rows under the row-sharded solver).
* Selector (``select.py``) — ``paper`` (``PaperSelector``, the eq. 56
  heuristic, KKT termination), ``mvp`` and ``block`` (``BlockSelector``,
  top-P pairs per sweep), and ``ShardedBlockSelector`` (per-rank
  candidates, one all_gather).
* Driver (``driver.py``) — the one loop with the stall/patience/gap logic;
  ``stats.py`` holds rho recovery and the KKT / duality-gap diagnostics,
  the combines (``LocalComm``; ``MeshComm`` over ``torch.distributed``)
  and the ``CollectiveLedger``.
* Warm start (``state.py``) — ``SolverArtifact`` (a finished fit as a
  checkpointable restart point) and ``prepare_warm_start``.
"""
from repro_torch.core.engine.driver import (gauss_seidel_pairs,
                                            has_converged, init_state, run)
from repro_torch.core.engine.gram import (BLOCK, SINGLE_PASS_MAX, FusedGram,
                                          OnTheFlyGram, PallasGram,
                                          PrecomputedGram, ShardedGram,
                                          make_provider, raw_scores_blocked)
from repro_torch.core.engine.select import (BlockSelector, PaperSelector,
                                            ShardedBlockSelector,
                                            make_selector)
from repro_torch.core.engine.state import (SolverArtifact, WarmStart,
                                           WarmStartInfo,
                                           artifact_from_result, clip_to_box,
                                           match_rows, prepare_warm_start,
                                           row_hashes)
from repro_torch.core.engine.stats import (LOCAL_COMM, CollectiveLedger,
                                           CollectiveRecord, LocalComm,
                                           MeshComm, recover_rhos,
                                           slab_margin, solver_stats_fresh,
                                           solver_stats_prev, violation)
from repro_torch.core.engine.types import Selection, SMOResult, SolverState

__all__ = [
    "run", "init_state", "gauss_seidel_pairs", "has_converged",
    "make_provider", "PrecomputedGram", "OnTheFlyGram", "FusedGram",
    "PallasGram",
    "ShardedGram", "raw_scores_blocked", "SINGLE_PASS_MAX", "BLOCK",
    "make_selector", "PaperSelector", "BlockSelector",
    "ShardedBlockSelector", "LocalComm", "LOCAL_COMM", "MeshComm",
    "CollectiveLedger", "CollectiveRecord", "recover_rhos", "slab_margin",
    "violation", "solver_stats_fresh", "solver_stats_prev", "Selection", "SMOResult", "SolverState",
    "SolverArtifact", "WarmStart", "WarmStartInfo", "artifact_from_result",
    "clip_to_box", "match_rows", "prepare_warm_start", "row_hashes",
]

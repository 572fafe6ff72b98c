"""Batched scoring engine: padding buckets over the decision kernel.

Every request is padded up to one of ``BUCKETS`` row counts before it
reaches the kernel, so the service sees a handful of launch shapes;
requests larger than the top bucket are chunked through it. numpy
requests (the service boundary) are padded and unpadded host-side and
come back as numpy; tensor requests stay tensors.

Two execution paths share the packing:

* local   — ``decision_packed`` on the model's device,
* sharded — ``mesh=``: one process per rank (SPMD, every rank calling
  ``score`` with the same queries); queries are padded to the per-rank
  bucket times the data axis's size, each rank scores its slice through
  the same ``decision_packed`` against the replicated support set, and
  one all_gather returns the full result on every rank.

Scoring runs at the model's packed ``precision``: the support block is
already in the serving tile dtype, queries are cast per launch, and the
accumulate/epilogue stays f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.stats import MeshComm
from repro_torch.kernels.decision.ops import decision_packed
from repro_torch.kernels.tiling import LANE, _pad_to
from repro_torch.serve.model_cache import ServingModel

# Request row-counts are padded up to one of these; the top bucket is also
# the chunk size for larger batches.
BUCKETS = (64, 256, 1024, 4096)


def bucket_for(n: int) -> int:
    """Smallest bucket >= n (the top bucket for anything larger)."""
    if n < 1:
        raise ValueError(f"need at least one query row, got {n}")
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


class BatchScorer:
    """Scores query batches against one ``ServingModel`` on its device.

    ``mesh`` (a ``repro_torch.launch.SolverMesh``) switches on the sharded
    path: queries are padded to ``bucket * mesh.shape[data_axis]`` rows
    and each rank scores its own slice against the replicated support
    set; every rank of the mesh calls ``score`` with the same queries.
    """

    def __init__(self, model: ServingModel, *, mesh=None,
                 data_axis: str = "data"):
        if mesh is not None and data_axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {data_axis!r}: "
                             f"{tuple(mesh.shape)}")
        self.model = model
        self.mesh = mesh
        self.data_axis = data_axis
        self._comm = (None if mesh is None
                      else MeshComm((data_axis,), mesh=mesh))
        self.device = model.t_pad.device
        self._d_pad = int(model.t_pad.shape[1])
        # The slab offsets as host floats, read once: the kernel takes
        # them as scalars, so no launch waits on a device read.
        self._rho = (float(model.rho1), float(model.rho2))
        # Buckets warmup() has launched (and built the kernel for): the
        # service records a warmed bucket's first launch as warm.
        self.warmed_buckets: set = set()

    # -- padding ------------------------------------------------------------
    def _pad_queries(self, q, rows: int) -> torch.Tensor:
        """(n, d) -> (rows, d_pad) f32 on the model's device, zero padded
        (numpy inputs in one host buffer, then one copy)."""
        if isinstance(q, np.ndarray):
            out = np.zeros((rows, self._d_pad), np.float32)
            out[:q.shape[0], :q.shape[1]] = q
            return torch.from_numpy(out).to(self.device)
        q = q.to(device=self.device, dtype=torch.float32)
        return _pad_to(_pad_to(q, rows, 0), LANE, 1)

    @staticmethod
    def _tm(bucket: int) -> int:
        # The JAX package's query tile for a bucket; decision_packed
        # checks the bucket against it.
        return min(bucket, 256)

    def _check(self, q):
        if q.ndim != 2:
            raise ValueError(f"queries must be (n, d), got {tuple(q.shape)}")
        if q.shape[1] != self.model.d:
            raise ValueError(f"query feature dim {q.shape[1]} != model "
                             f"feature dim {self.model.d}")

    def _score_bucket(self, q_pad: torch.Tensor) -> torch.Tensor:
        m = self.model
        return decision_packed(q_pad, m.t_pad, m.gamma_pad, m.t_norms,
                               *self._rho, m.spec.kernel,
                               tm=self._tm(q_pad.shape[0]), tn=m.tn,
                               precision=m.precision)

    def _n_ranks(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape[self.data_axis])

    def chunk_rows(self) -> int:
        """Rows one launch can take: the top bucket, times the data axis's
        size on the sharded path (each rank gets a top-bucket slice)."""
        return BUCKETS[-1] * self._n_ranks()

    def bucket_used(self, n: int) -> int:
        """The padding bucket one single-launch n-row request lands in —
        the per-rank bucket on the sharded path."""
        if self.mesh is None:
            return bucket_for(n)
        return bucket_for(max(1, -(-n // self._n_ranks())))

    def launch_plan(self, n: int):
        """(rows, bucket) per kernel launch for an n-row request — full
        top-capacity chunks first, then the remainder in its own (often
        smaller) bucket."""
        cap = self.chunk_rows()
        sizes = [cap] * (n // cap) + ([n % cap] if n % cap else [])
        return [(rows, self.bucket_used(rows)) for rows in sizes]

    def score(self, q):
        """Slab decision values (n, d) -> (n,). Batches beyond one
        launch's capacity are chunked; numpy in, numpy out."""
        self._check(q)
        n = int(q.shape[0])
        cap = self.chunk_rows()
        if n > cap:
            chunks = [self._score_once(q[i:i + cap])
                      for i in range(0, n, cap)]
            if isinstance(chunks[0], np.ndarray):
                return np.concatenate(chunks)
            return torch.cat(chunks)
        return self._score_once(q)

    def _score_once(self, q):
        n = int(q.shape[0])
        if self.mesh is None:
            out = self._score_bucket(self._pad_queries(q, bucket_for(n)))
        else:
            out = self._score_sharded(q, n)
        if isinstance(q, np.ndarray):
            return out.cpu().numpy()[:n]
        return out[:n]

    def _score_sharded(self, q, n: int) -> torch.Tensor:
        per_rank = self.bucket_used(n)
        q_pad = self._pad_queries(q, per_rank * self._n_ranks())
        r = self.mesh.coords()[self.data_axis]
        out = self._score_bucket(q_pad[r * per_rank:(r + 1) * per_rank])
        return self._comm.all_gather(out, tiled=True)

    def warmup(self) -> None:
        """Launch every bucket once (and build the kernel, on first use):
        on the sharded path, every per-rank bucket (``b * n_ranks`` rows
        land on per-rank bucket ``b``)."""
        for b in BUCKETS:
            q = torch.zeros((b * self._n_ranks(), self.model.d),
                            dtype=torch.float32, device=self.device)
            self._score_once(q)
            self.warmed_buckets.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

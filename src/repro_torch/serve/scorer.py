"""Batched scoring engine: padding buckets over the decision kernel.

Every request is padded up to one of ``BUCKETS`` row counts before it
reaches the kernel, so the service sees a handful of launch shapes;
requests larger than the top bucket are chunked through it. numpy
requests (the service boundary) are padded and unpadded host-side and
come back as numpy; tensor requests stay tensors.

Scoring runs at the model's packed ``precision``: the support block is
already in the serving tile dtype, queries are cast per launch, and the
accumulate/epilogue stays f32.
"""
from __future__ import annotations

import numpy as np
import torch

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

    ``mesh=`` (the JAX package's sharded path) is not ported yet and
    raises ``NotImplementedError``.
    """

    def __init__(self, model: ServingModel, *, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded scorer (mesh=) needs the distributed path: "
                "ROADMAP A.9 (distributed)")
        self.model = model
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

    def chunk_rows(self) -> int:
        """Rows one launch can take: the top bucket."""
        return BUCKETS[-1]

    def bucket_used(self, n: int) -> int:
        """The padding bucket one single-launch n-row request lands in."""
        return bucket_for(n)

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
        out = self._score_bucket(self._pad_queries(q, bucket_for(n)))
        if isinstance(q, np.ndarray):
            return out.cpu().numpy()[:n]
        return out[:n]

    def warmup(self) -> None:
        """Launch every bucket once (and build the kernel, on first use)."""
        for b in BUCKETS:
            q = torch.zeros((b, self.model.d), dtype=torch.float32,
                            device=self.device)
            self._score_once(q)
            self.warmed_buckets.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

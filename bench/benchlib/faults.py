"""The control and the planted faults that the check must refuse.

Each replaces ``BatchScorer._score_bucket`` of the program (the launch of
one padded query block) for the length of a ``with`` block. ``bench/run.py``
never uses them: the tests run them on the CPU at a small size, and
``bench/tools/readings.py`` runs the control on the card at the cell's
size.

* ``control``: the plain reference in the program's place, with the rows
  rounded to the precision below the configuration's (TF32 for f32 with
  TF32 off, float8 e4m3 for bf16).
* ``stale``: every launch after the first returns the previous launch's
  answers (a step that hands its state back unchanged).
* ``half_rows``: the second half of each block is left out and given the
  mean of the first half's answers.
* ``half_support``: half of the support rows left out, the sum over the
  rest doubled.
* ``altered``: one answer of each launch moved by a tenth of the block's
  largest.
"""
from __future__ import annotations

import contextlib

import torch

from reference import slab as reference

FAULTS = ("stale", "half_rows", "half_support", "altered")


@contextlib.contextmanager
def _replace(fn):
    from repro_torch.serve.scorer import BatchScorer
    orig = BatchScorer._score_bucket
    BatchScorer._score_bucket = lambda self, q_pad: fn(self, q_pad, orig)
    try:
        yield
    finally:
        BatchScorer._score_bucket = orig


def control(slab, precision: str):
    """The reference at ``precision`` scoring what the program is given."""
    d = slab.t.shape[1]

    def score(self, q_pad, orig):
        return reference.decision(q_pad[:, :d], slab.t, slab.gamma,
                                  slab.rho1, slab.rho2, slab.kgamma,
                                  precision=precision).to(torch.float32)
    return _replace(score)


def fault(kind: str):
    last = {}

    def stale(self, q_pad, orig):
        out = orig(self, q_pad)
        prev = last.get(out.shape[0])
        last[out.shape[0]] = out
        return out if prev is None else prev

    def half_rows(self, q_pad, orig):
        out = orig(self, q_pad).clone()
        h = max(1, out.shape[0] // 2)
        out[h:] = out[:h].mean()
        return out

    def half_support(self, q_pad, orig):
        from repro_torch.kernels.decision.ops import decision_packed
        m = self.model
        h = max(m.tn, m.t_pad.shape[0] // 2 // m.tn * m.tn)
        return decision_packed(q_pad, m.t_pad[:h], 2.0 * m.gamma_pad[:h],
                               m.t_norms[:h], *self._rho, m.spec.kernel,
                               tm=self._tm(q_pad.shape[0]), tn=m.tn,
                               precision=m.precision)

    def altered(self, q_pad, orig):
        out = orig(self, q_pad).clone()
        out[0] += 0.1 * out.abs().max()
        return out

    fns = {"stale": stale, "half_rows": half_rows,
           "half_support": half_support, "altered": altered}
    if kind not in fns:
        raise ValueError(f"unknown fault {kind!r}; expected one of {FAULTS}")
    return _replace(fns[kind])

"""Plain PyTorch versions of the two scans: the Mamba selective scan and
the RWKV6 WKV recurrence, in f32, with the JAX package's chunked remat.

The JAX package runs each scan as a ``lax.scan`` over chunks of
``min(chunk, S)`` steps, each chunk under ``jax.checkpoint``
(``src/repro/models/mamba.py:47-84``, ``src/repro/models/rwkv.py:96-125``):
its backward pass keeps one carry a chunk and recomputes the chunk's steps.
Each scan's arithmetic is stated once, as the steps of one chunk
(``_ssm_chunk``, ``_wkv_chunk``); two generic drivers run a chunk function
over the chunks:

* ``_scan``: forward. With ``remat`` each chunk runs under
  ``torch.utils.checkpoint`` (``ssm_scan_plain`` / ``wkv6_plain``:
  differentiable by autograd, the reference's structure, and the version
  the CUDA kernels are held against on the card); without, it also returns
  the carry at each chunk's start, (B, nc, ...) (``ssm_scan_fwd_plain`` /
  ``wkv6_fwd_plain``: the forward of the ``kernels.scan.ops`` custom ops on
  the CPU).
* ``_scan_vjp``: the backward of those ops on the CPU. Each chunk, last to
  first, is recomputed from its carry under autograd, which gives the
  chunk's input gradients from the gradient of its outputs.

Only the real steps are scanned: the chunks are ``range(0, S, ck)``, the
last one short. For Mamba that equals the reference's zero-padded tail
(dt = 0 leaves h unchanged); for RWKV the reference's zero-padded ``w``
wipes the state (ROADMAP C.13), which the port does not copy.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
CHUNK = 128


def n_chunks(S: int, chunk: int = CHUNK) -> Tuple[int, int]:
    """(steps a chunk, chunks) of an S-step scan: ``min(chunk, S)`` steps
    a chunk, the last one short."""
    ck = max(1, min(chunk, S))
    return ck, -(-S // ck)


def chunks(S: int, chunk: int = CHUNK) -> List[Tuple[int, int]]:
    """The (start, stop) steps of each chunk."""
    ck, nc = n_chunks(S, chunk)
    return [(c * ck, min((c + 1) * ck, S)) for c in range(nc)]


# ---------------------------------------------------------------------------
# the drivers: chunk_fn(*seqs over one chunk, *params, carry) -> (y, carry)
# ---------------------------------------------------------------------------

def _scan(chunk_fn: Callable, seqs: Sequence[Tensor],
          params: Sequence[Tensor], h0: Tensor, chunk: int, remat: bool):
    """(y, the carry after the last step, the carry at each chunk's start
    stacked on dim 1, or None with ``remat``). ``seqs`` are (B, S, ...),
    split over the chunks on dim 1; ``params`` go to every chunk."""
    ys, carries, h = [], [], h0
    for t0, t1 in chunks(seqs[0].shape[1], chunk):
        args = (*(t[:, t0:t1] for t in seqs), *params, h)
        if remat:
            y, h = checkpoint(chunk_fn, *args, use_reentrant=False)
        else:
            carries.append(h)
            y, h = chunk_fn(*args)
        ys.append(y)
    return (torch.cat(ys, dim=1), h,
            None if remat else torch.stack(carries, dim=1))


@contextlib.contextmanager
def _autograd_inside_an_operator():
    """Autograd on in a custom operator's implementation, which the
    dispatcher runs with the autograd keys excluded."""
    keys = torch._C.DispatchKey
    exclude = (torch._C._dispatch_tls_local_exclude_set()
               .remove(keys.AutogradFunctionality)
               .remove(keys.ADInplaceOrView))
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        yield


def _scan_vjp(chunk_fn: Callable, gy: Tensor, g_last: Tensor,
              seqs: Sequence[Tensor], params: Sequence[Tensor],
              carries: Tensor, chunk: int) -> Tuple[Tensor, ...]:
    """The gradients (of each of ``seqs``, of each of ``params``, of the
    first carry) of ``_scan(chunk_fn, seqs, params, ...)`` given gy (the
    gradient of y) and g_last (of the last carry); ``carries`` as
    ``_scan`` returns them."""
    dseqs = [torch.empty_like(t) for t in seqs]
    dparams = [torch.zeros_like(p) for p in params]
    g = g_last
    spans = chunks(seqs[0].shape[1], chunk)
    for c in reversed(range(len(spans))):
        sl = slice(*spans[c])
        with _autograd_inside_an_operator():
            ins = [t.detach().requires_grad_() for t in (
                *(s[:, sl] for s in seqs), *params, carries[:, c])]
            outs = chunk_fn(*ins)
            grads = torch.autograd.grad(outs, ins, (gy[:, sl], g))
        for d, gr in zip(dseqs, grads):
            d[:, sl] = gr
        for d, gr in zip(dparams, grads[len(seqs):-1]):
            d += gr
        g = grads[-1]
    return (*dseqs, *dparams, g)


# ---------------------------------------------------------------------------
# Mamba: h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t;  y_t = h_t C_t + D u_t
# ---------------------------------------------------------------------------

def _ssm_chunk(u, dt, B, C, A, D, h) -> Tuple[Tensor, Tensor]:
    """The steps of one chunk: (y (Bt, ck, inner), h after them)."""
    ys = []
    for t in range(u.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A[None])       # (Bt, inner, N)
        h = dA * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t])
                  + D[None] * u[:, t])
    return torch.stack(ys, dim=1), h


def ssm_scan_plain(u: Tensor, dt: Tensor, B: Tensor, C: Tensor, A: Tensor,
                   D: Tensor, h0: Tensor, chunk: int = CHUNK
                   ) -> Tuple[Tensor, Tensor]:
    """u, dt: (Bt, S, inner); B, C: (Bt, S, N); A: (inner, N); D: (inner,);
    h0: (Bt, inner, N); all f32. Returns (y (Bt, S, inner), h after the
    last step). Autograd saves one carry a chunk (plus the inputs' views)
    and recomputes the chunk in the backward pass."""
    return _scan(_ssm_chunk, (u, dt, B, C), (A, D), h0, chunk, True)[:2]


def ssm_scan_fwd_plain(u, dt, B, C, A, D, h0, chunk: int = CHUNK
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """``ssm_scan_plain``'s values and the carry at each chunk's start:
    (y, h_last, carries (Bt, nc, inner, N))."""
    return _scan(_ssm_chunk, (u, dt, B, C), (A, D), h0, chunk, False)


def ssm_scan_bwd_plain(gy, gh, u, dt, B, C, A, D, carries,
                       chunk: int = CHUNK) -> Tuple[Tensor, ...]:
    """The gradients (du, ddt, dB, dC, dA, dD, dh0) of ``ssm_scan_plain``
    given gy (Bt, S, inner) and gh (the gradient of h_last)."""
    return _scan_vjp(_ssm_chunk, gy, gh, (u, dt, B, C), (A, D), carries,
                     chunk)


# ---------------------------------------------------------------------------
# RWKV6: y_t = r_t (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1}
#        + k_t v_t^T
# ---------------------------------------------------------------------------

def _wkv_chunk(r, k, v, w, u, S) -> Tuple[Tensor, Tensor]:
    """The steps of one chunk, r/k/v/w (B, ck, H, D), S (B, H, D, D):
    (y (B, ck, H, D), S after them)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, ..., None] * v[:, t, :, None, :]      # (B, H, D, D)
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, ..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
               S0: Tensor, chunk: int = CHUNK) -> Tuple[Tensor, Tensor]:
    """r, k, v, w: (B, S, H, D); u: (H, D); S0: (B, H, D, D); all f32.
    Returns (y (B, S, H, D), the state after the last real step), each
    chunk under ``torch.utils.checkpoint`` as in ``ssm_scan_plain``."""
    return _scan(_wkv_chunk, (r, k, v, w), (u,), S0, chunk, True)[:2]


def wkv6_fwd_plain(r, k, v, w, u, S0, chunk: int = CHUNK
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """``wkv6_plain``'s values and the carry at each chunk's start:
    (y, S_last, carries (B, nc, H, D, D))."""
    return _scan(_wkv_chunk, (r, k, v, w), (u,), S0, chunk, False)


def wkv6_bwd_plain(gy, gS, r, k, v, w, u, carries, chunk: int = CHUNK
                   ) -> Tuple[Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du, dS0) of ``wkv6_plain`` given
    gy (B, S, H, D) and gS (the gradient of the last state)."""
    return _scan_vjp(_wkv_chunk, gy, gS, (r, k, v, w), (u,), carries, chunk)

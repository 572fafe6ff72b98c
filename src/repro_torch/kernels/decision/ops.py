"""Wrappers of the slab decision kernel (``csrc/decision.cu``).

``precision`` casts the query/support rows to bf16/f16 before the
kernel; gamma, the norms, the accumulator and the slab epilogue
``(s - rho1) * (rho2 - s)`` stay f32 (``repro_torch.kernels.precision``).
On the packed serving path the support block is stored in the serving
dtype once, at model-pack time.

The device of the tensors picks the path: CPU tensors get the plain
version (``ref.decision_plain``), CUDA tensors the kernel; there is no
fallback from one to the other. ``DECISION.launches`` counts the
kernel's launches from both wrappers. ``prepare`` / ``prepare_packed``
and ``launch`` are each wrapper's two halves: the operands the kernel and
its plain version both take, and the kernel's launch on them.

The kernel splits the support rows over CTAs and adds each query's
partial sums in split order (``csrc/split_rows.cuh``): ``launch``
allocates the (splits, queries) f32 workspace beside the output
(``tiling.decision_splits``). The precision picks the class (f32 SIMT,
bf16/f16 wgmma fed by TMA). TMA needs 16-byte aligned rows, so
``prepare`` lays 16-bit rows on the card out as ``gram``'s wrapper does:
features zero-padded to a multiple of 8 after rounding and after taking
the norms (``tiling.tma_rows``); the packed operands have a multiple of
128 features already. A 16-bit launch takes an entry whose query tile
fits shared memory at its d (``tiling.wgmma_fits``): resident up to
d = 1664, streamed above.

``decision`` takes its launch shape from ``tiling.resolve_tiles``
(``tiles``: the tuned table keyed on (support rows, d, precision,
"cuda"), unless ``tm``/``tn`` are given); ``decision_packed`` stays off
the table, as in the JAX package, and launches the entry the bucket
picks (``tiling.packed_decision_config``). Every entry of a class gives
bitwise the same output. During a ``repro_torch.utils.trace``
recording, ``decision_packed`` marks its two halves with spans:
``repro_torch.decision.prepare`` (``prepare_packed``: the cast and the
norms) and ``repro_torch.decision.launch``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.kernel_fn import KernelFn
from repro_torch.kernels._build import Kernel, Launch
from repro_torch.kernels.decision.ref import decision_plain
from repro_torch.kernels.fupdate.ops import (DTYPE_CODES, KIND_CODES,
                                             as_tile, row_norms)
from repro_torch.kernels.precision import precision_of, tile_dtype
from repro_torch.kernels.tiling import (LANE, TileConfig, backend_name,
                                        decision_splits, default_config,
                                        menu_index, packed_decision_config,
                                        resolve_tiles, tma_rows)
from repro_torch.utils import trace

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DECISION = Kernel("decision", "decision_launch",
                  [_P] * 7 + [_I] * 5 + [_F, _F, _I, _F, _F, _I, _P])


def prepare(q, t, gamma_vec, *, precision: str = "f32"
            ) -> Tuple[torch.Tensor, ...]:
    """``decision``'s operands ``(q, t, gamma_vec, qn, tnorm)``: the rows
    in the tile dtype, contiguous, with the f32 squared norms of the
    rounded, unpadded rows; 16-bit rows on the card laid out for TMA
    (``tma_rows``)."""
    dt = tile_dtype(precision)
    q = as_tile(q, dt)
    t = as_tile(t, dt)
    if q.ndim != 2 or t.ndim != 2 or q.shape[1] != t.shape[1] \
            or gamma_vec.shape != (t.shape[0],):
        raise ValueError(f"decision shapes: q {tuple(q.shape)}, t "
                         f"{tuple(t.shape)}, gamma {tuple(gamma_vec.shape)}")
    qn, tn = row_norms(q).contiguous(), row_norms(t).contiguous()
    if dt != torch.float32 and q.device.type == "cuda":
        q, t = tma_rows(q), tma_rows(t)
    return q, t, gamma_vec.to(torch.float32).contiguous(), qn, tn


def tiles(q, t, *, tm: Optional[int] = None,
          tn: Optional[int] = None) -> TileConfig:
    """``decision``'s launch config for prepared queries q and support
    rows t (``tiling.resolve_tiles``)."""
    return resolve_tiles("decision", m=t.shape[0], d=q.shape[1],
                         n=q.shape[0], precision=precision_of(q.dtype),
                         backend=backend_name(q), block_m=tm, block_n=tn)


def launch(q, t, gamma_vec, qn, tnorm, rho1, rho2, kernel: KernelFn,
           cfg: Optional[TileConfig] = None) -> Launch:
    """The kernel's launch on prepared CUDA operands (``prepare`` or
    ``prepare_packed``), into a new (nq,) f32 output and a new
    (splits, nq) f32 workspace, on the current stream of q's card, with
    tile config ``cfg`` (default: the default of the rows' class, or the
    first entry of the class that fits d)."""
    dev = q.device
    nq, d = q.shape
    nt = t.shape[0]
    if cfg is None:
        cfg = default_config("decision", precision=precision_of(q.dtype),
                             d=d)
    out = torch.empty((nq,), dtype=torch.float32, device=dev)
    ws = torch.empty((decision_splits(nt, cfg), nq), dtype=torch.float32,
                     device=dev)
    return Launch(DECISION, dev.index, (
        q.data_ptr(), t.data_ptr(), gamma_vec.data_ptr(), qn.data_ptr(),
        tnorm.data_ptr(), ws.data_ptr(), out.data_ptr(), nq, nt, d,
        DTYPE_CODES[q.dtype], KIND_CODES[kernel.name], float(kernel.gamma),
        float(kernel.coef0), int(kernel.degree), float(rho1), float(rho2),
        menu_index("decision", cfg),
        torch.cuda.current_stream(dev).cuda_stream), out, cfg, ws)


def _run(q, t, gamma_vec, qn, tnorm, rho1, rho2, kernel: KernelFn,
         cfg: Optional[TileConfig] = None):
    """Plain version on the CPU, the kernel on CUDA (with ``cfg``, see
    ``launch``; the plain version takes no padded features, and on the
    CPU ``prepare`` pads none)."""
    rho1, rho2 = float(rho1), float(rho2)
    dev = q.device
    if any(a.device != dev for a in (t, gamma_vec, qn, tnorm)):
        raise ValueError("decision operands must share one device")
    if dev.type == "cpu":
        return decision_plain(q, t, gamma_vec, qn, tnorm, rho1, rho2,
                              kind=kernel.name, gamma=kernel.gamma,
                              coef0=kernel.coef0, degree=kernel.degree)
    if dev.type != "cuda":
        raise ValueError(f"decision runs on cpu or cuda, not {dev.type}")
    if q.shape[0] == 0:
        return torch.empty((0,), dtype=torch.float32, device=dev)
    return launch(q, t, gamma_vec, qn, tnorm, rho1, rho2, kernel, cfg)()


def decision(q, t, gamma_vec, rho1, rho2, kernel: KernelFn, *,
             tm: Optional[int] = None, tn: Optional[int] = None,
             precision: str = "f32") -> torch.Tensor:
    """Slab decision values for queries q (nq, d) against the support set
    (t (nt, d), gamma_vec (nt,)); any shapes (the kernel masks ragged
    edges). ``tm``/``tn`` (queries per CTA, support rows per split) opt
    out of the tuned table; ``None`` resolves from it. Returns (nq,) f32
    ``(s - rho1) * (rho2 - s)``."""
    ops = prepare(q, t, gamma_vec, precision=precision)
    cfg = None
    if ops[0].device.type == "cuda" or tm is not None or tn is not None:
        cfg = tiles(ops[0], ops[1], tm=tm, tn=tn)
    return _run(*ops, rho1, rho2, kernel, cfg)


def prepare_packed(q_pad, t_pad, gamma_pad, t_norms, *, tm: int = 256,
                   tn: int = 512, precision: str = "f32"
                   ) -> Tuple[torch.Tensor, ...]:
    """``decision_packed``'s operands ``(q, t, gamma_vec, qn, tnorm)``,
    checked against the pack geometry as the JAX package checks them."""
    if q_pad.shape[0] % tm or t_pad.shape[0] % tn or q_pad.shape[1] % LANE:
        raise ValueError(
            f"decision_packed needs pre-padded operands: got q "
            f"{tuple(q_pad.shape)} (rows % tm={tm}, features % {LANE}) and "
            f"t {tuple(t_pad.shape)} (rows % tn={tn})")
    if q_pad.shape[1] != t_pad.shape[1]:
        raise ValueError(f"feature-dim mismatch: q {tuple(q_pad.shape)} vs "
                         f"t {tuple(t_pad.shape)}")
    dt = tile_dtype(precision)
    q_pad = as_tile(q_pad, dt)
    return (q_pad, as_tile(t_pad, dt),
            gamma_pad.reshape(-1).to(torch.float32).contiguous(),
            row_norms(q_pad).contiguous(),
            t_norms.reshape(-1).to(torch.float32).contiguous())


def decision_packed(q_pad, t_pad, gamma_pad, t_norms, rho1, rho2,
                    kernel: KernelFn, *, tm: int = 256, tn: int = 512,
                    precision: str = "f32") -> torch.Tensor:
    """Decision values against a support set already packed to the tile grid.

    The serving fast path: ``t_pad`` (M_pad, d_pad) in the serving tile
    dtype, ``gamma_pad`` (M_pad, 1) and ``t_norms`` (M_pad, 1) f32 were
    padded/precomputed once at pack time (gamma is zero on padding rows,
    so they add exactly nothing), and the query block arrives padded to a
    bucket shape. Returns all ``q_pad.shape[0]`` values; the caller
    slices its live rows. ``tm``/``tn`` are the pack geometry; the launch's
    entry is the one ``tiling.packed_decision_config`` picks for the
    bucket and the width (the kernel masks ragged edges, so its query tile
    need not be ``tm``).
    """
    with trace.span("repro_torch.decision.prepare"):
        ops = prepare_packed(q_pad, t_pad, gamma_pad, t_norms, tm=tm, tn=tn,
                             precision=precision)
    cfg = packed_decision_config(ops[0].shape[0], precision, ops[0].shape[1])
    with trace.span("repro_torch.decision.launch"):
        return _run(*ops, rho1, rho2, kernel, cfg)

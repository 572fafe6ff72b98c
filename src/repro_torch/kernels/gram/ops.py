"""Wrapper of the kernel-matrix kernel (``csrc/gram.cu``).

``precision`` ("f32" default, "bf16", "f16") casts the data rows to the
tile dtype before the kernel — halving the streamed bytes — while the
norms are computed in f32 from the rounded rows and the dot products
accumulate in f32 (``repro_torch.kernels.precision``).

The device of the tensors picks the path: CPU tensors get the plain
version (``ref.gram_plain``), CUDA tensors the kernel; there is no
fallback from one to the other. ``GRAM.launches`` counts the kernel's
launches. ``prepare`` and ``launch`` are the wrapper's two halves: the
operands of the kernel, and its launch on them.

The precision picks the kernel (``tiling``'s classes): f32 rows run the
SIMT kernels on the CUDA cores, which mask ragged rows, columns and
features themselves; bf16/f16 rows run the wgmma kernel, which reads
them by TMA. TMA needs a 16-byte aligned base and a row stride that is a
multiple of 16 bytes, so ``prepare`` lays 16-bit rows out for it: after
rounding to the tile dtype and taking the norms, it zero-pads the
feature axis to a multiple of 8 (d = 45 -> 48, d = 129 -> 136) and
copies rows whose base is not 16-byte aligned to a fresh tensor. Zero
features add exactly nothing to a dot product, and the norms are those
of the unpadded rows. This is a layout step, not a fallback: every
16-bit launch on the card is a wgmma launch. Rows past M and N are TMA's
out-of-bounds zero fill and are not stored.

The launch shape comes from ``tiling.resolve_tiles`` (``tiles``): the
tuned table keyed on (max(M, N), D, precision, "cuda") among the entries
of the precision's class, unless ``tm``/``tn``/``tk`` are given; every
entry of a class gives bitwise the same matrix. Callers: the autotuner
(``kernels/autotune.py``); the solvers build their kernel blocks with
``KernelFn.cross``, as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.kernel_fn import KernelFn
from repro_torch.kernels._build import Kernel, Launch
from repro_torch.kernels.fupdate.ops import (DTYPE_CODES, KIND_CODES,
                                             as_tile, row_norms)
from repro_torch.kernels.gram.ref import gram_plain
from repro_torch.kernels.precision import precision_of, tile_dtype
from repro_torch.kernels.tiling import (TileConfig, _pad_to, backend_name,
                                        menu_index, resolve_tiles)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
GRAM = Kernel("gram", "gram_launch",
              [_P] * 5 + [_I] * 5 + [_F, _F, _I, _I, _P])

# 16-bit features a TMA row stride is a multiple of (16 bytes).
TMA_FEATURES = 8


def tma_rows(a: torch.Tensor) -> torch.Tensor:
    """16-bit rows as TMA reads them: the features zero-padded to a
    multiple of :data:`TMA_FEATURES`, on a 16-byte aligned base."""
    a = _pad_to(a, TMA_FEATURES, axis=1)
    return a.clone() if a.data_ptr() % 16 else a


def prepare(x, y, *, precision: str = "f32") -> Tuple[torch.Tensor, ...]:
    """The kernel's operands ``(x, y, xn, yn)``: the rows in the tile
    dtype, contiguous (16-bit rows laid out for TMA by :func:`tma_rows`),
    and the f32 squared norms of the rounded, unpadded rows."""
    dt = tile_dtype(precision)
    x = as_tile(x, dt)
    y = as_tile(y, dt)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"gram shapes: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError("gram operands must share one device")
    xn, yn = row_norms(x).contiguous(), row_norms(y).contiguous()
    if dt != torch.float32:
        x, y = tma_rows(x), tma_rows(y)
    return x, y, xn, yn


def tiles(x, y, *, tm: Optional[int] = None, tn: Optional[int] = None,
          tk: Optional[int] = None) -> TileConfig:
    """The launch config for prepared rows x (M, D), y (N, D)
    (``tiling.resolve_tiles``, keyed on max(M, N), among the entries of
    the rows' precision's class)."""
    return resolve_tiles("gram", m=max(x.shape[0], y.shape[0]),
                         d=x.shape[1], precision=precision_of(x.dtype),
                         backend=backend_name(x), block_m=tm, block_n=tn,
                         block_k=tk)


def launch(x, y, xn, yn, kernel: KernelFn,
           cfg: Optional[TileConfig] = None) -> Launch:
    """The kernel's launch on prepared CUDA operands (see ``prepare``),
    into a new (M, N) f32 output, on the current stream of x's card, with
    tile config ``cfg`` (default: the wrapper's, ``tiles``)."""
    dev = x.device
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if cfg is None:
        cfg = tiles(x, y)
    return Launch(GRAM, dev.index, (
        x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
        out.data_ptr(), m, n, d, DTYPE_CODES[x.dtype],
        KIND_CODES[kernel.name], float(kernel.gamma), float(kernel.coef0),
        int(kernel.degree), menu_index("gram", cfg),
        torch.cuda.current_stream(dev).cuda_stream), out, cfg)


def gram(x, y, kernel: KernelFn, *, tm: Optional[int] = None,
         tn: Optional[int] = None, tk: Optional[int] = None,
         precision: str = "f32") -> torch.Tensor:
    """K[i, j] = k(x_i, y_j) — the full kernel matrix.

    Args:
      x: (M, D) rows (any float dtype; cast to f32, then the tile dtype).
      y: (N, D) rows, same feature dim as ``x``.
      kernel: ``KernelFn`` ("rbf" / "linear" / "poly").
      tm, tn, tk: rows / columns per CTA and feature-chunk depth of the
        launch; ``None`` (default) resolves from the tuned table; passing
        any opts out of it (``repro_torch.kernels.tiling``). Not read on
        the CPU beyond checking them against the menu.
      precision: tile-input stream dtype ("f32"/"bf16"/"f16").

    Returns:
      (M, N) f32 kernel matrix.
    """
    ops = prepare(x, y, precision=precision)
    dev = ops[0].device
    cfg = None
    if dev.type == "cuda" or any(v is not None for v in (tm, tn, tk)):
        cfg = tiles(ops[0], ops[1], tm=tm, tn=tn, tk=tk)
    if dev.type == "cpu":
        return gram_plain(x, y, kind=kernel.name,
                          gamma=kernel.gamma, coef0=kernel.coef0,
                          degree=kernel.degree, precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"gram runs on cpu or cuda, not {dev.type}")
    if ops[0].shape[0] == 0 or ops[1].shape[0] == 0:
        return torch.empty((ops[0].shape[0], ops[1].shape[0]),
                           dtype=torch.float32, device=dev)
    return launch(*ops, kernel, cfg)()

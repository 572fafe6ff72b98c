"""Wrapper of the fused SMO f-cache update kernel (``csrc/fupdate.cu``).

``precision`` casts the streamed data rows (x and the selected block) to
bf16/f16; delta, f, the norms and the rank-S matvec epilogue stay f32
(see ``repro_torch.kernels.precision``).

The device of the tensors picks the path: CPU tensors get the plain
version (``ref.fupdate_plain``), CUDA tensors the kernel; there is no
fallback from one to the other. ``FUPDATE.launches`` counts the kernel's
launches. ``prepare`` and ``launch`` are the wrapper's two halves: the
operands the kernel and its plain version both take, and the kernel's
launch on them.

The launch shape comes from ``tiling.resolve_tiles`` (``tiles``): the
tuned table keyed on (m, d, precision, "cuda") among the menu entries of
the selected block's class (S <= 32 or above), unless ``tm``/``tk`` are
given; every entry of a class gives bitwise the same output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.kernel_fn import KernelFn
from repro_torch.kernels._build import Kernel, Launch
from repro_torch.kernels.fupdate.ref import fupdate_plain
from repro_torch.kernels.precision import precision_of, tile_dtype
from repro_torch.kernels.tiling import (TileConfig, backend_name,
                                        menu_index, resolve_tiles)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FUPDATE = Kernel("fupdate", "fupdate_launch",
                 [_P] * 7 + [_I] * 5 + [_F, _F, _I, _I, _P])

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KIND_CODES = {"linear": 0, "rbf": 1, "poly": 2}


def as_tile(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Rows in the tile dtype, contiguous (a no-op when they already are:
    f32 -> tile dtype rounds once; re-casting rounded rows is exact)."""
    if x.dtype != dt:
        x = x.to(torch.float32).to(dt)
    return x.contiguous()


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """f32 squared norms of the (already rounded) rows."""
    xf = x.to(torch.float32)
    return torch.sum(xf * xf, dim=-1)


def prepare(x, xsel, delta, f, *, precision: str = "f32",
            xn: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands ``(x, xsel, delta, f, xn, seln)``: x and xsel
    in the tile dtype, the rest f32, all contiguous and on one device."""
    dt = tile_dtype(precision)
    x = as_tile(x, dt)
    xsel = as_tile(xsel, dt)
    xn = (row_norms(x) if xn is None else xn).to(torch.float32).contiguous()
    seln = row_norms(xsel).contiguous()
    delta = delta.to(torch.float32).contiguous()
    f = f.to(torch.float32).contiguous()
    m, d = x.shape
    s = xsel.shape[0]
    if xsel.shape[1] != d or delta.shape != (s,) or f.shape != (m,) \
            or xn.shape != (m,):
        raise ValueError(f"fupdate shapes: x {tuple(x.shape)}, xsel "
                         f"{tuple(xsel.shape)}, delta {tuple(delta.shape)}, "
                         f"f {tuple(f.shape)}, xn {tuple(xn.shape)}")
    if any(t.device != x.device for t in (xsel, delta, f, xn)):
        raise ValueError("fupdate operands must share one device")
    return x, xsel, delta, f, xn, seln


def tiles(x, s: int, *, tm: Optional[int] = None,
          tk: Optional[int] = None) -> TileConfig:
    """The launch config for prepared rows x (m, d) and S = ``s`` selected
    rows (``tiling.resolve_tiles``)."""
    m, d = x.shape
    return resolve_tiles("fupdate", m=m, d=d, n=s,
                         precision=precision_of(x.dtype),
                         backend=backend_name(x), block_m=tm, block_k=tk)


def launch(x, xsel, delta, f, xn, seln, kernel: KernelFn,
           cfg: Optional[TileConfig] = None) -> Launch:
    """The kernel's launch on prepared CUDA operands (see ``prepare``),
    into a new (m,) f32 output, on the current stream of x's card, with
    tile config ``cfg`` (default: the wrapper's, ``tiles``)."""
    dev = x.device
    out = torch.empty_like(f)
    m, d = x.shape
    if cfg is None:
        cfg = tiles(x, xsel.shape[0])
    return Launch(FUPDATE, dev.index, (
        x.data_ptr(), xsel.data_ptr(), delta.data_ptr(), f.data_ptr(),
        xn.data_ptr(), seln.data_ptr(), out.data_ptr(), m, xsel.shape[0], d,
        DTYPE_CODES[x.dtype], KIND_CODES[kernel.name], float(kernel.gamma),
        float(kernel.coef0), int(kernel.degree), menu_index("fupdate", cfg),
        torch.cuda.current_stream(dev).cuda_stream), out, cfg)


def fupdate(x, xsel, delta, f, kernel: KernelFn, *,
            tm: Optional[int] = None, tk: Optional[int] = None,
            precision: str = "f32",
            xn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f + k(x, xsel) @ delta — the SMO hot-loop rank-S update, fused.

    Args:
      x: (m, d) training rows, read once per call.
      xsel: (s, d) the selected block; any s (the kernel loops over it).
      delta: (s,) dual step.
      f: (m,) f32 score cache.
      kernel: ``KernelFn`` with host-float parameters.
      tm, tk: rows per CTA / feature-chunk depth of the launch; ``None``
        (default) resolves from the tuned table; passing either opts out
        of it (``repro_torch.kernels.tiling``). Not read on the CPU
        beyond checking them against the menu.
      precision: tile-input dtype ("f32"/"bf16"/"f16").
      xn: optional (m,) f32 norms of x's rounded rows, for callers that
        reuse one x across calls (the solver computes them once).

    Returns:
      (m,) f32 updated score cache.
    """
    ops = prepare(x, xsel, delta, f, precision=precision, xn=xn)
    dev = ops[0].device
    cfg = None
    if dev.type == "cuda" or tm is not None or tk is not None:
        cfg = tiles(ops[0], ops[1].shape[0], tm=tm, tk=tk)
    if dev.type == "cpu":
        return fupdate_plain(*ops, kind=kernel.name, gamma=kernel.gamma,
                             coef0=kernel.coef0, degree=kernel.degree)
    if dev.type != "cuda":
        raise ValueError(f"fupdate runs on cpu or cuda, not {dev.type}")
    if ops[0].shape[0] == 0:
        return torch.empty_like(ops[3])
    return launch(*ops, kernel, cfg)()

"""The two scans as custom operators: ``repro_torch::ssm_scan_fwd`` /
``ssm_scan_bwd`` (Mamba, ``csrc/ssm_scan.cu``) and ``repro_torch::wkv6_fwd``
/ ``wkv6_bwd`` (RWKV6, ``csrc/wkv6.cu``).

Each forward op returns its outputs and the carry at each chunk's start
(``ref.chunks``: ``min(chunk, S)`` steps a chunk, the last one short);
``register_autograd`` links it to its backward op, which recomputes each
chunk from its carry, last chunk first. So autograd saves the inputs and
one carry a chunk, never a state a step: the JAX package's
``jax.checkpoint`` of each chunk (ROADMAP C.20).

Each op has three implementations, picked by the tensors' device:

* CUDA: the hand-written kernels, through ``_build.Kernel`` (a kernel that
  fails to build or launch raises; nothing falls back to the plain
  version). ``SSM_FWD.launches`` etc. count them.
* CPU: the plain versions of ``ref`` (``ssm_scan_fwd_plain``,
  ``ssm_scan_bwd_plain``, ...).
* Fake (``meta`` and tracing): the shapes only, so the dry run's op
  stream sees one operation a layer and a pass.

Each op has a FLOP formula in ``torch.utils.flop_counter``'s registry
(which ``utils.cost_analysis`` reads), the FLOPs the plain version's
operations count under the same registry: forward, the y einsum (2 Bt S
inner N; 2 B S H D D); backward, the chunk's recompute and the two
gradient einsums (three times that). The backward ops also give the
bytes of their kernels' workspace (``cost_analysis.WORKSPACE_BYTES``), so
the dry run's peak holds it.

Everything is f32, as in the reference, which casts the scans' inputs to
f32 before its ``lax.scan``. ``N`` (Mamba's state size) must be 8 or 16
and ``D`` (RWKV's head size) 16 or 64 on the card: the kernels keep a
state row in registers and are compiled for those sizes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import Kernel, Launch
from repro_torch.kernels.scan.ref import (CHUNK, n_chunks,
                                          ssm_scan_bwd_plain,
                                          ssm_scan_fwd_plain, wkv6_bwd_plain,
                                          wkv6_fwd_plain)
from repro_torch.utils.cost_analysis import WORKSPACE_BYTES

Tensor = torch.Tensor
_P, _I = ctypes.c_void_p, ctypes.c_int

SSM_FWD = Kernel("ssm_scan", "ssm_scan_fwd_launch", [_P] * 10 + [_I] * 5
                 + [_P])
SSM_BWD = Kernel("ssm_scan", "ssm_scan_bwd_launch", [_P] * 17
                 + [ctypes.c_int64] + [_I] * 5 + [_P])
WKV_FWD = Kernel("wkv6", "wkv6_fwd_launch", [_P] * 9 + [_I] * 5 + [_P])
WKV_BWD = Kernel("wkv6", "wkv6_bwd_launch", [_P] * 16 + [ctypes.c_int64]
                 + [_I] * 5 + [_P])
KERNELS = (SSM_FWD, SSM_BWD, WKV_FWD, WKV_BWD)

# Channels a CTA of the Mamba kernels (csrc/ssm_scan.cu's CH).
SSM_CHANNELS = 64
SSM_STATES = (8, 16)
# The longest chunk the Mamba kernels take (csrc/ssm_scan.cu's kMaxChunk:
# the backward keeps the starts of a chunk's sub-chunks in shared memory,
# and the forward refuses what its backward would).
SSM_MAX_CHUNK = 256
WKV_HEAD_DIMS = (16, 64)
# Steps a sub-chunk of the WKV backward kernel (csrc/wkv6.cu's L).
WKV_SUBCHUNK = 8


def _f32_on(dev, *ts) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"the scan kernels take f32 tensors on one "
                             f"device; got {t.dtype} on {t.device}, {dev} "
                             f"expected")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned (the scan kernels stage their
    inputs by 16-byte copies); a view at another offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssm_bwd_workspace(bt, S, inner, N):
    """The shapes of the Mamba backward kernel's f32 workspace, one flat
    buffer in this order: dB's and dC's per-CTA partial sums (a CTA a
    ``SSM_CHANNELS`` channels), then the per-row partials of dA and dD.
    The states it recomputes stay on the chip (the sub-chunk starts in
    shared memory), so the chunk does not enter."""
    nblk = -(-inner // SSM_CHANNELS)
    return ((nblk, bt, S, N), (nblk, bt, S, N), (bt, inner, N), (bt, inner))


def wkv6_bwd_workspace(b, S, H, D, chunk: int = CHUNK):
    """The shapes of the WKV backward kernel's f32 workspace: the states at
    the starts of one chunk's sub-chunks of ``WKV_SUBCHUNK`` steps but the
    first (the carry) and the last (kept in registers), and du's per-row
    partials."""
    ck, _ = n_chunks(S, chunk)
    starts = max(-(-ck // WKV_SUBCHUNK) - 2, 0)
    return ((b, H, starts, D, D), (b, H, D))


def _f32_bytes(shapes) -> int:
    return sum(4 * math.prod(s) for s in shapes)


def _ssm_chunks(S, chunk):
    """``n_chunks(S, chunk)`` for the Mamba kernels, which take chunks of at
    most ``SSM_MAX_CHUNK`` steps: both launches raise for a longer one,
    so a forward whose backward would be refused does no work."""
    ck, nc = n_chunks(S, chunk)
    if ck > SSM_MAX_CHUNK:
        raise ValueError(f"ssm_scan on the card takes chunks of at most "
                         f"{SSM_MAX_CHUNK} steps, not {ck}")
    return ck, nc


# ---------------------------------------------------------------------------
# the kernels' launches
# ---------------------------------------------------------------------------

def launch_ssm_fwd(u, dt, B, C, A, D, h0, chunk: int = CHUNK) -> Launch:
    """The forward kernel's launch on CUDA operands, into new (y, h_last,
    carries); chunks of at most ``SSM_MAX_CHUNK`` steps."""
    dev = u.device
    _f32_on(dev, u, dt, B, C, A, D, h0)
    bt, S, inner = u.shape
    N = A.shape[1]
    if N not in SSM_STATES:
        raise ValueError(f"ssm_scan on the card takes N in {SSM_STATES}, "
                         f"not {N}")
    if (dt.shape != u.shape or B.shape != (bt, S, N) or C.shape != B.shape
            or A.shape != (inner, N) or D.shape != (inner,)
            or h0.shape != (bt, inner, N)):
        raise ValueError("ssm_scan shapes: u, dt (Bt, S, inner); B, C "
                         "(Bt, S, N); A (inner, N); D (inner,); h0 "
                         "(Bt, inner, N)")
    _, nc = _ssm_chunks(S, chunk)
    ops = [_aligned(t) for t in (u, dt, B, C, A, D, h0)]
    y = torch.empty((bt, S, inner), dtype=torch.float32, device=dev)
    h = torch.empty((bt, inner, N), dtype=torch.float32, device=dev)
    carries = torch.empty((bt, nc, inner, N), dtype=torch.float32,
                          device=dev)
    return Launch(SSM_FWD, dev.index, (
        *(t.data_ptr() for t in ops), y.data_ptr(), h.data_ptr(),
        carries.data_ptr(), bt, S, inner, N, chunk, _stream(dev)),
        (y, h, carries), None, ops)


def launch_ssm_bwd(gy, gh, u, dt, B, C, A, D, carries,
                   chunk: int = CHUNK) -> Launch:
    """The backward kernel's launch on CUDA operands, into new (du, ddt,
    dB, dC, dA, dD, dh0). Its workspace (``ssm_bwd_workspace``, one flat
    buffer; the kernel refuses one of another size): the per-CTA /
    per-row partial sums that a second pass adds in a fixed order."""
    dev = u.device
    _f32_on(dev, gy, gh, u, dt, B, C, A, D, carries)
    bt, S, inner = u.shape
    N = A.shape[1]
    _, nc = _ssm_chunks(S, chunk)
    if (gy.shape != u.shape or gh.shape != (bt, inner, N)
            or carries.shape != (bt, nc, inner, N)):
        raise ValueError("ssm_scan_bwd shapes: gy as u, gh (Bt, inner, N), "
                         "carries (Bt, nc, inner, N)")
    ops = [_aligned(t) for t in (gy, gh, u, dt, B, C, A, D, carries)]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((bt, S, inner), **f32),
            torch.empty((bt, S, inner), **f32),
            torch.empty((bt, S, N), **f32), torch.empty((bt, S, N), **f32),
            torch.empty((inner, N), **f32), torch.empty((inner,), **f32),
            torch.empty((bt, inner, N), **f32))
    ws = torch.empty(_f32_bytes(ssm_bwd_workspace(bt, S, inner, N)) // 4,
                     **f32)
    return Launch(SSM_BWD, dev.index, (
        *(t.data_ptr() for t in ops), *(t.data_ptr() for t in outs),
        ws.data_ptr(), ws.numel(), bt, S, inner, N, chunk, _stream(dev)),
        outs, None, (ops, ws))


def launch_wkv6_fwd(r, k, v, w, u, S0, chunk: int = CHUNK) -> Launch:
    """The forward kernel's launch on CUDA operands, into new (y, S_last,
    carries)."""
    dev = r.device
    _f32_on(dev, r, k, v, w, u, S0)
    b, S, H, D = r.shape
    if D not in WKV_HEAD_DIMS:
        raise ValueError(f"wkv6 on the card takes D in {WKV_HEAD_DIMS}, "
                         f"not {D}")
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, D)
            or S0.shape != (b, H, D, D)):
        raise ValueError("wkv6 shapes: r, k, v, w (B, S, H, D); u (H, D); "
                         "S0 (B, H, D, D)")
    ops = [_aligned(t) for t in (r, k, v, w, u, S0)]
    _, nc = n_chunks(S, chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, S, H, D), **f32)
    S_last = torch.empty((b, H, D, D), **f32)
    carries = torch.empty((b, nc, H, D, D), **f32)
    return Launch(WKV_FWD, dev.index, (
        *(t.data_ptr() for t in ops), y.data_ptr(), S_last.data_ptr(),
        carries.data_ptr(), b, S, H, D, chunk, _stream(dev)),
        (y, S_last, carries), None, ops)


def launch_wkv6_bwd(gy, gS, r, k, v, w, u, carries,
                    chunk: int = CHUNK) -> Launch:
    """The backward kernel's launch on CUDA operands, into new (dr, dk, dv,
    dw, du, dS0); workspace: ``wkv6_bwd_workspace`` (the kernel refuses
    a workspace of another size)."""
    dev = r.device
    _f32_on(dev, gy, gS, r, k, v, w, u, carries)
    b, S, H, D = r.shape
    _, nc = n_chunks(S, chunk)
    if (gy.shape != r.shape or gS.shape != (b, H, D, D)
            or carries.shape != (b, nc, H, D, D)):
        raise ValueError("wkv6_bwd shapes: gy as r, gS (B, H, D, D), "
                         "carries (B, nc, H, D, D)")
    ops = [_aligned(t) for t in (gy, gS, r, k, v, w, u, carries)]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = tuple(torch.empty((b, S, H, D), **f32) for _ in range(4)) + (
        torch.empty((H, D), **f32), torch.empty((b, H, D, D), **f32))
    ws = tuple(torch.empty(s, **f32)
               for s in wkv6_bwd_workspace(b, S, H, D, chunk))
    return Launch(WKV_BWD, dev.index, (
        *(t.data_ptr() for t in ops), *(t.data_ptr() for t in outs),
        *(t.data_ptr() for t in ws), ws[0].numel(), b, S, H, D, chunk,
        _stream(dev)), outs, None, (ops, ws))


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssm_scan_fwd", mutates_args=(),
                         device_types="cpu")
def ssm_scan_fwd(u: Tensor, dt: Tensor, B: Tensor, C: Tensor, A: Tensor,
                 D: Tensor, h0: Tensor, chunk: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    return ssm_scan_fwd_plain(u, dt, B, C, A, D, h0, chunk)


@ssm_scan_fwd.register_kernel("cuda")
def _ssm_scan_fwd_cuda(u, dt, B, C, A, D, h0, chunk):
    return launch_ssm_fwd(u, dt, B, C, A, D, h0, chunk)()


@ssm_scan_fwd.register_fake
def _ssm_scan_fwd_fake(u, dt, B, C, A, D, h0, chunk):
    bt, S, inner = u.shape
    _, nc = n_chunks(S, chunk)
    return (u.new_empty((bt, S, inner)), h0.new_empty(h0.shape),
            h0.new_empty((bt, nc, inner, A.shape[1])))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=(),
                         device_types="cpu")
def ssm_scan_bwd(gy: Tensor, gh: Tensor, u: Tensor, dt: Tensor, B: Tensor,
                 C: Tensor, A: Tensor, D: Tensor, carries: Tensor, chunk: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                            Tensor]:
    return ssm_scan_bwd_plain(gy, gh, u, dt, B, C, A, D, carries, chunk)


@ssm_scan_bwd.register_kernel("cuda")
def _ssm_scan_bwd_cuda(gy, gh, u, dt, B, C, A, D, carries, chunk):
    return launch_ssm_bwd(gy, gh, u, dt, B, C, A, D, carries, chunk)()


@ssm_scan_bwd.register_fake
def _ssm_scan_bwd_fake(gy, gh, u, dt, B, C, A, D, carries, chunk):
    return tuple(t.new_empty(t.shape) for t in (u, dt, B, C, A, D, gh))


def _ssm_setup(ctx, inputs, output):
    u, dt, B, C, A, D, _, chunk = inputs
    ctx.save_for_backward(u, dt, B, C, A, D, output[2])
    ctx.chunk = chunk
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)


def _ssm_backward(ctx, gy, gh, _g_carries):
    u, dt, B, C, A, D, carries = ctx.saved_tensors
    gy = torch.zeros_like(u) if gy is None else gy
    gh = torch.zeros_like(carries[:, 0]) if gh is None else gh
    grads = torch.ops.repro_torch.ssm_scan_bwd(gy, gh, u, dt, B, C, A, D,
                                               carries, ctx.chunk)
    return (*grads, None)


ssm_scan_fwd.register_autograd(_ssm_backward, setup_context=_ssm_setup)


@torch.library.custom_op("repro_torch::wkv6_fwd", mutates_args=(),
                         device_types="cpu")
def wkv6_fwd(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             S0: Tensor, chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    return wkv6_fwd_plain(r, k, v, w, u, S0, chunk)


@wkv6_fwd.register_kernel("cuda")
def _wkv6_fwd_cuda(r, k, v, w, u, S0, chunk):
    return launch_wkv6_fwd(r, k, v, w, u, S0, chunk)()


@wkv6_fwd.register_fake
def _wkv6_fwd_fake(r, k, v, w, u, S0, chunk):
    b, S, H, D = r.shape
    _, nc = n_chunks(S, chunk)
    return (r.new_empty(r.shape), S0.new_empty(S0.shape),
            S0.new_empty((b, nc, H, D, D)))


@torch.library.custom_op("repro_torch::wkv6_bwd", mutates_args=(),
                         device_types="cpu")
def wkv6_bwd(gy: Tensor, gS: Tensor, r: Tensor, k: Tensor, v: Tensor,
             w: Tensor, u: Tensor, carries: Tensor, chunk: int
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return wkv6_bwd_plain(gy, gS, r, k, v, w, u, carries, chunk)


@wkv6_bwd.register_kernel("cuda")
def _wkv6_bwd_cuda(gy, gS, r, k, v, w, u, carries, chunk):
    return launch_wkv6_bwd(gy, gS, r, k, v, w, u, carries, chunk)()


@wkv6_bwd.register_fake
def _wkv6_bwd_fake(gy, gS, r, k, v, w, u, carries, chunk):
    return tuple(t.new_empty(t.shape) for t in (r, k, v, w, u, gS))


def _wkv6_setup(ctx, inputs, output):
    r, k, v, w, u, _, chunk = inputs
    ctx.save_for_backward(r, k, v, w, u, output[2])
    ctx.chunk = chunk
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)


def _wkv6_backward(ctx, gy, gS, _g_carries):
    r, k, v, w, u, carries = ctx.saved_tensors
    gy = torch.zeros_like(r) if gy is None else gy
    gS = torch.zeros_like(carries[:, 0]) if gS is None else gS
    grads = torch.ops.repro_torch.wkv6_bwd(gy, gS, r, k, v, w, u, carries,
                                           ctx.chunk)
    return (*grads, None)


wkv6_fwd.register_autograd(_wkv6_backward, setup_context=_wkv6_setup)


# ---------------------------------------------------------------------------
# FLOP formulas (shapes in, FLOPs out; see the module docstring)
# ---------------------------------------------------------------------------

def ssm_scan_flops(u_shape, A_shape) -> int:
    """The forward's FLOPs: the y einsum, 2 Bt S inner N."""
    bt, S, inner = u_shape
    return 2 * bt * S * inner * A_shape[1]


def wkv6_flops(r_shape) -> int:
    """The forward's FLOPs: the y einsum, 2 B S H D D."""
    b, S, H, D = r_shape
    return 2 * b * S * H * D * D


@register_flop_formula(torch.ops.repro_torch.ssm_scan_fwd)
def _ssm_fwd_flop(u, dt, B, C, A, *args, **kwargs) -> int:
    return ssm_scan_flops(u, A)


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def _ssm_bwd_flop(gy, gh, u, dt, B, C, A, *args, **kwargs) -> int:
    return 3 * ssm_scan_flops(u, A)


@register_flop_formula(torch.ops.repro_torch.wkv6_fwd)
def _wkv6_fwd_flop(r, *args, **kwargs) -> int:
    return wkv6_flops(r)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _wkv6_bwd_flop(gy, gS, r, *args, **kwargs) -> int:
    return 3 * wkv6_flops(r)


# The backward kernels' workspaces, for the dry run's peak (on the card
# they live only while the kernel runs).
WORKSPACE_BYTES[torch.ops.repro_torch.ssm_scan_bwd] = (
    lambda gy, gh, u, dt, B, C, A, D, carries, chunk: _f32_bytes(
        ssm_bwd_workspace(*u.shape, A.shape[1])))
WORKSPACE_BYTES[torch.ops.repro_torch.wkv6_bwd] = (
    lambda gy, gS, r, k, v, w, u, carries, chunk: _f32_bytes(
        wkv6_bwd_workspace(*r.shape, chunk)))


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

def ssm_scan(u, dt, B, C, A, D, h0, chunk: int = CHUNK
             ) -> Tuple[Tensor, Tensor]:
    """The Mamba scan (``ref.ssm_scan_plain``'s values): (y (Bt, S, inner),
    h after the last step), differentiable, one op a pass."""
    y, h, _ = torch.ops.repro_torch.ssm_scan_fwd(
        *(t.contiguous() for t in (u, dt, B, C, A, D, h0)), chunk)
    return y, h


def wkv6(r, k, v, w, u, S0, chunk: int = CHUNK) -> Tuple[Tensor, Tensor]:
    """The RWKV6 recurrence (``ref.wkv6_plain``'s values): (y (B, S, H, D),
    the state after the last step), differentiable, one op a pass."""
    y, S, _ = torch.ops.repro_torch.wkv6_fwd(
        *(t.contiguous() for t in (r, k, v, w, u, S0)), chunk)
    return y, S


def reset_counts() -> None:
    for kern in KERNELS:
        kern.reset_counts()

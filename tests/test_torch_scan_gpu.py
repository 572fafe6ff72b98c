"""The scan kernels (``csrc/ssm_scan.cu``, ``csrc/wkv6.cu``) held against
their plain versions on the card.

    python -m pytest -m gpu tests/test_torch_scan_gpu.py

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, so every worker collects the same tests). The file
imports nothing of JAX: the machine with the card has no JAX. Each
kernel's forward and backward (through the ``repro_torch::*`` operators
and autograd) against autograd through ``ref.ssm_scan_plain`` /
``ref.wkv6_plain`` on the same inputs, at N in {8, 16} and D in {16, 64},
S in {1, 7, 20, 129, 131, 136, 300, 4096} (ragged against both forwards'
staging blocks of 16 steps, both backwards' sub-chunks of 8 and the
chunks of 128), within the f32 ``TOLERANCES`` (``truth_tolerance``: both
compute in f32 and differ in rounding and summation order only); two
backward runs bitwise equal (the kernels' sums are fixed-order); a
prefill of S steps bitwise S one-step calls; each backward's global
workspace the size ``ops.ssm_bwd_workspace`` / ``ops.wkv6_bwd_workspace``
states (the kernel refuses another); a ragged ``inner`` that is no
multiple of 4 (the Mamba kernels then stage by 4-byte copies) and
inputs that are views at an offset (the launches copy them).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import resolve_device
from repro_torch.kernels.precision import truth_tolerance
from repro_torch.kernels.scan import ops as sops
from repro_torch.kernels.scan import ref as sref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # and TF32 off


def _ssm_inputs(seed, S, N, bt=2, inner=200):
    """inner = 200: three full CTAs of 64 channels (``ops.SSM_CHANNELS``,
    256 threads at 4 lanes a channel) and a ragged one of 8."""
    rng = np.random.default_rng(seed)
    u, B, C = (rng.standard_normal(s).astype(np.float32)
               for s in ((bt, S, inner), (bt, S, N), (bt, S, N)))
    dt = rng.uniform(0.01, 0.3, (bt, S, inner)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (inner, 1))
    D = np.ones(inner, np.float32)
    h0 = (0.5 * rng.standard_normal((bt, inner, N))).astype(np.float32)
    return [u, dt, B, C, A, D, h0]


def _wkv_inputs(seed, S, D, b=2, H=3):
    """b x H = 6 (b, h) states, one CTA each."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 0.5, (b, S, H, D)))) \
        .astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    S0 = (0.5 * rng.standard_normal((b, H, D, D))).astype(np.float32)
    return [r, k, v, w, u, S0]


def _vjp(fn, arrays, cots, dev):
    ts = [torch.as_tensor(a, device=dev).requires_grad_() for a in arrays]
    outs = fn(*ts)
    torch.autograd.backward(outs, [torch.as_tensor(c, device=dev)
                                   for c in cots])
    torch.cuda.synchronize()
    return [o.detach() for o in outs], [t.grad for t in ts]


def _held(got, want, names):
    for name, g, w in zip(names, got, want):
        w = w.detach().float().cpu().numpy()
        np.testing.assert_allclose(g.detach().float().cpu().numpy(), w,
                                   err_msg=name,
                                   **truth_tolerance("f32", w))


CASES = {"ssm_scan": (sops.ssm_scan, sref.ssm_scan_plain, _ssm_inputs,
                      (8, 16), "y h".split(), "u dt B C A D h0".split(),
                      (sops.SSM_FWD, sops.SSM_BWD)),
         "wkv6": (sops.wkv6, sref.wkv6_plain, _wkv_inputs, (16, 64),
                  "y S".split(), "r k v w u S0".split(),
                  (sops.WKV_FWD, sops.WKV_BWD))}


@pytest.mark.parametrize("S", [1, 7, 20, 129, 131, 136, 300, 4096])
@pytest.mark.parametrize("size_ix", [0, 1])
@pytest.mark.parametrize("family", sorted(CASES))
def test_kernels_match_their_plain_versions(cuda, family, size_ix, S):
    op, plain, make, sizes, outs_n, ins_n, (fwd_k, bwd_k) = CASES[family]
    arrays = make(S, S, sizes[size_ix])
    rng = np.random.default_rng(S + 1)
    # y has the first input's shape, the last state the first state's.
    cots = [rng.standard_normal(a.shape).astype(np.float32)
            for a in (arrays[0], arrays[-1])]
    n0 = (fwd_k.launches, bwd_k.launches)
    outs, grads = _vjp(op, arrays, cots, cuda)
    outs2, grads2 = _vjp(op, arrays, cots, cuda)
    assert (fwd_k.launches - n0[0], bwd_k.launches - n0[1]) == (2, 2)
    for a, b in zip(outs2 + grads2, outs + grads):
        assert torch.equal(a, b)
    ref_outs, ref_grads = _vjp(plain, arrays, cots, cuda)
    _held(outs, ref_outs, outs_n)
    _held(grads, ref_grads, ins_n)


@pytest.mark.parametrize("family", sorted(CASES))
def test_prefill_is_bitwise_one_step_calls(cuda, family):
    """A step's arithmetic does not depend on S: a scan of 131 steps and
    131 scans of one step, each from the last one's state, give the same
    bits (the LM's decode against its full forward)."""
    op, _, make, sizes, *_ = CASES[family]
    arrays = [torch.as_tensor(a, device=cuda)
              for a in make(0, 131, sizes[-1])]
    y, state = op(*arrays)
    ys, st = [], arrays[-1]
    for t in range(131):
        yt, st = op(*[a[:, t:t + 1] for a in arrays[:4]], *arrays[4:-1], st)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(st, state)


def test_kernels_refuse_cpu_fallback_and_bad_types(cuda):
    arrays = [torch.as_tensor(a, device=cuda)
              for a in _ssm_inputs(0, 5, 16)]
    with pytest.raises(ValueError):
        sops.launch_ssm_fwd(*[a.double() for a in arrays])
    with pytest.raises(ValueError):
        sops.launch_ssm_fwd(*arrays[:-1], arrays[-1].cpu())


def test_wkv6_backward_workspace_is_the_stated_size(cuda):
    """The backward's global workspace: the sub-chunk starts of one chunk
    (``ops.wkv6_bwd_workspace``), at most 128 MiB at rwkv6-7b's B = 4,
    S = 512; the kernel refuses a workspace of another size."""
    ws = sops.wkv6_bwd_workspace(4, 512, 64, 64)
    assert sum(4 * int(np.prod(s)) for s in ws) <= 128 * 2**20
    arrays = [torch.as_tensor(a, device=cuda)
              for a in _wkv_inputs(0, 300, 64)]
    _, _, carries = sops.launch_wkv6_fwd(*arrays)()
    gy = torch.ones_like(arrays[0])
    gS = torch.ones_like(arrays[-1])
    ln = sops.launch_wkv6_bwd(gy, gS, *arrays[:5], carries)
    assert [tuple(t.shape) for t in ln.scratch[1]] == list(
        sops.wkv6_bwd_workspace(2, 300, 3, 64))
    assert ln.args[16] == ln.scratch[1][0].numel() > 0
    ln()
    torch.cuda.synchronize()
    short = dataclasses.replace(ln, args=(*ln.args[:16], ln.args[16] - 1,
                                          *ln.args[17:]))
    with pytest.raises(RuntimeError, match="wkv6_bwd_launch failed"):
        short()


def test_ssm_backward_workspace_is_the_stated_size(cuda):
    """The backward's global workspace: dB's and dC's per-CTA partials and
    dA's and dD's per-row ones (``ops.ssm_bwd_workspace``, one flat
    buffer), at most 150 MiB at jamba's B = 1, S = 4096, inner 16384, N 16
    (the recomputed states stay on the chip); the kernel refuses a
    workspace of another size, and the launch a chunk past
    ``SSM_MAX_CHUNK``."""
    ws = sops.ssm_bwd_workspace(1, 4096, 16384, 16)
    assert sum(4 * int(np.prod(s)) for s in ws) <= 150 * 2**20
    arrays = [torch.as_tensor(a, device=cuda)
              for a in _ssm_inputs(0, 300, 16)]
    _, _, carries = sops.launch_ssm_fwd(*arrays)()
    gy = torch.ones_like(arrays[0])
    gh = torch.ones_like(arrays[-1])
    ln = sops.launch_ssm_bwd(gy, gh, *arrays[:6], carries)
    stated = sum(int(np.prod(s)) for s in sops.ssm_bwd_workspace(2, 300,
                                                                  200, 16))
    assert ln.scratch[1].numel() == ln.args[17] == stated
    ln()
    torch.cuda.synchronize()
    short = dataclasses.replace(ln, args=(*ln.args[:17], ln.args[17] - 1,
                                          *ln.args[18:]))
    with pytest.raises(RuntimeError, match="ssm_scan_bwd_launch failed"):
        short()
    with pytest.raises(ValueError, match="chunks of at most"):
        sops.launch_ssm_bwd(gy, gh, *arrays[:6], carries[:, :1],
                            chunk=sops.SSM_MAX_CHUNK + 44)


def test_ssm_ragged_inner_and_unaligned_views(cuda):
    """inner = 133 (two full CTAs and a ragged one of 5 channels; rows not
    16-byte aligned, so the kernels stage by 4-byte copies), S = 137, and
    inputs that are views at an offset of one float (the launches copy
    them), against the plain versions; two backward runs bitwise equal."""
    arrays = _ssm_inputs(4, 137, 16, bt=3, inner=133)
    flat = [torch.as_tensor(np.concatenate([[0.0], a.ravel()]).astype(
        np.float32), device=cuda).requires_grad_() for a in arrays]
    views = [f[1:].view(a.shape) for f, a in zip(flat, arrays)]
    assert all(v.data_ptr() % 16 for v in views)
    rng = np.random.default_rng(6)
    cots = [torch.as_tensor(rng.standard_normal(a.shape).astype(np.float32),
                            device=cuda) for a in (arrays[0], arrays[-1])]
    outs = sops.ssm_scan(*views)
    torch.autograd.backward(outs, cots)
    grads = [f.grad[1:].view(a.shape).clone() for f, a in zip(flat, arrays)]
    for f in flat:
        f.grad = None
    torch.autograd.backward(sops.ssm_scan(*views), cots)
    assert all(torch.equal(f.grad[1:].view(a.shape), g)
               for f, a, g in zip(flat, arrays, grads))
    ref_live = [torch.as_tensor(a, device=cuda).requires_grad_()
                for a in arrays]
    ref_outs = sref.ssm_scan_plain(*ref_live)
    torch.autograd.backward(ref_outs, cots)
    torch.cuda.synchronize()
    _held(outs, ref_outs, "y h".split())
    _held(grads, [t.grad for t in ref_live], "u dt B C A D h0".split())


def test_wkv6_odd_grid_and_unaligned_views(cuda):
    """b x H = 15 CTAs, S = 137, and inputs that are views at an offset
    of one float (the kernels stage by 16-byte copies: the launch copies
    such a view) against the plain versions."""
    arrays = _wkv_inputs(3, 137, 64, b=3, H=5)
    flat = [torch.as_tensor(np.concatenate([[0.0], a.ravel()]).astype(
        np.float32), device=cuda).requires_grad_() for a in arrays]
    views = [f[1:].view(a.shape) for f, a in zip(flat, arrays)]
    assert all(v.data_ptr() % 16 for v in views)
    rng = np.random.default_rng(5)
    cots = [torch.as_tensor(rng.standard_normal(a.shape).astype(np.float32),
                            device=cuda) for a in (arrays[0], arrays[-1])]
    outs = sops.wkv6(*views)
    torch.autograd.backward(outs, cots)
    ref_live = [torch.as_tensor(a, device=cuda).requires_grad_()
                for a in arrays]
    ref_outs = sref.wkv6_plain(*ref_live)
    torch.autograd.backward(ref_outs, cots)
    torch.cuda.synchronize()
    _held(outs, ref_outs, "y S".split())
    _held([f.grad[1:].view(a.shape) for f, a in zip(flat, arrays)],
          [t.grad for t in ref_live], "r k v w u S0".split())

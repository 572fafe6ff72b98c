"""Training step: loss, (accumulated) gradients, clipping, optimizer
update — the JAX package's ``repro.train.train_step`` on one device.

The step is a closure over the static ``ArchConfig``. The state's
parameters are a ``param_tree`` (the JAX package's layout, ``Stacked``
per-layer tensors for its stacked leaves) of plain tensors; each step
takes detached aliases of them that require gradients, so the state
itself carries no autograd graph and checkpoints, copies and restores as
a plain tree. The optimizer writes the new parameters into the state's
tensors (the ``Decoder`` they came from, if any, serves the trained
weights). Microbatches (gradient accumulation) run as a Python loop over
slices of the batch: one microbatch's activations are live at a time.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Decoder, forward, param_tree
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils.tree import leaves, map_tree, unflatten

Tensor = torch.Tensor

AUX_LOSS_WEIGHT = 0.01
IGNORE_LABEL = -1
FUSED_CE_MIN_VOCAB = 65536


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token CE over labels != IGNORE_LABEL (f32 math)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = (labels != IGNORE_LABEL).float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunks(V: int, chunk: int) -> Tuple[int, int]:
    """(count, width) of the vocab chunks: the count divides V exactly
    (no padded copy of the matrix), as in the JAX package."""
    nc = max(1, (V + chunk - 1) // chunk)
    while V % nc:
        nc += 1
    return nc, V // nc


class _FusedUnembedCE(torch.autograd.Function):
    """Online-logsumexp CE over vocab chunks of ``hidden @ unembed``. The
    forward keeps no chunk's logits; the backward recomputes each chunk's
    (one extra unembed matmul) and turns it into that chunk's gradients."""

    @staticmethod
    def forward(ctx, hidden, unembed, labels, vocab_size, chunk):
        b, s, d = hidden.shape
        V = unembed.shape[-1]
        nc, chunk = _chunks(V, chunk)
        h = hidden.reshape(b * s, d)
        safe = torch.clamp(labels.reshape(-1).long(), min=0)
        mask = (labels.reshape(-1) != IGNORE_LABEL).float()
        m = torch.full((b * s,), -torch.inf, dtype=torch.float32,
                       device=h.device)
        ssum = torch.zeros((b * s,), dtype=torch.float32, device=h.device)
        lab = torch.zeros((b * s,), dtype=torch.float32, device=h.device)
        for ci in range(nc):
            lg = _chunk_logits(h, unembed, ci, chunk, vocab_size)
            m_new = torch.maximum(m, lg.max(dim=-1).values)
            ssum = ssum * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(-1)
            c0 = ci * chunk
            here = (safe >= c0) & (safe < c0 + chunk)
            idx = torch.clamp(safe - c0, 0, chunk - 1)
            lab = torch.where(here, torch.gather(lg, 1, idx[:, None])[:, 0],
                              lab)
            m = m_new
        lse = m + torch.log(ssum)
        count = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(hidden, unembed, safe, mask, lse, count)
        ctx.vocab, ctx.nc, ctx.chunk = vocab_size, nc, chunk
        return -((lab - lse) * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        hidden, unembed, safe, mask, lse, count = ctx.saved_tensors
        b, s, d = hidden.shape
        h = hidden.reshape(b * s, d)
        # d loss / d logit = (softmax - onehot(label)) * mask / count
        coef = g * mask / count
        gh = torch.zeros((b * s, d), dtype=torch.float32, device=h.device)
        gw = torch.empty_like(unembed)
        rows = torch.arange(b * s, device=h.device)
        for ci in range(ctx.nc):
            c0 = ci * ctx.chunk
            lg = _chunk_logits(h, unembed, ci, ctx.chunk, ctx.vocab)
            dl = torch.exp(lg - lse[:, None])
            here = (safe >= c0) & (safe < c0 + ctx.chunk)
            idx = torch.clamp(safe - c0, 0, ctx.chunk - 1)
            dl[rows, idx] -= here.float()
            dl = (dl * coef[:, None]).to(h.dtype)
            w = unembed[:, c0:c0 + ctx.chunk]
            gh += (dl @ w.T).float()
            gw[:, c0:c0 + ctx.chunk] = h.T @ dl
        return gh.to(hidden.dtype).reshape(b, s, d), gw, None, None, None


def _chunk_logits(h: Tensor, unembed: Tensor, ci: int, chunk: int,
                  vocab_size: int) -> Tensor:
    """Chunk ``ci``'s f32 logits, the padded vocab columns at -1e30."""
    c0 = ci * chunk
    lg = (h @ unembed[:, c0:c0 + chunk]).float()
    if c0 + chunk > vocab_size:
        lg[:, max(vocab_size - c0, 0):] = -1e30
    return lg


def fused_unembed_ce(hidden: Tensor, unembed: Tensor, labels: Tensor, *,
                     vocab_size: int, chunk: int = 16384) -> Tensor:
    """CE fused into the unembedding matmul, over vocab chunks.

    The full (tokens, V) logits never exist: each chunk computes
    hidden @ W[:, v:v+chunk], folds it into an online logsumexp (running
    max, scaled sum, label logit) and is dropped. The backward recomputes
    each chunk's logits (one extra unembed matmul of FLOPs): plain
    autograd would keep every chunk's f32 logits alive (about 1 GB at
    2048 tokens x 128,256). The gradient of ``hidden`` is summed over the
    chunks in f32 and cast once.
    """
    return _FusedUnembedCE.apply(hidden, unembed, labels, vocab_size, chunk)


def loss_fn(params, cfg: ArchConfig, batch: dict,
            constrain=lambda x, k: x) -> Tuple[Tensor, dict]:
    """(loss, {"ce", "aux"}) of a batch; ``params`` a ``Decoder`` or its
    ``param_tree``. ``constrain`` is the JAX package's sharding hook; on
    one device it is the identity and is not called."""
    kwargs = {}
    if "embeds" in batch:
        kwargs["embeds"] = batch["embeds"]
    else:
        kwargs["tokens"] = batch["tokens"]
    if "vision_embeds" in batch:
        kwargs["vision_embeds"] = batch["vision_embeds"]
    labels = batch["labels"]
    nv = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
    if cfg.padded_vocab >= FUSED_CE_MIN_VOCAB:
        hidden, _, aux = forward(params, cfg, return_hidden=True, **kwargs)
        ce = fused_unembed_ce(hidden[:, nv:], params["unembed"], labels,
                              vocab_size=cfg.vocab_size)
    else:
        logits, _, aux = forward(params, cfg, **kwargs)
        ce = cross_entropy(logits[:, nv:], labels)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def global_norm(tree) -> Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    """(tree * scale, norm), scale = min(1, max_norm / (norm + 1e-9)). A
    leaf of a narrower type than the f32 scale comes back in f32, as the
    JAX package's type promotion has it."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return map_tree(lambda x: x.to(torch.promote_types(x.dtype, scale.dtype))
                    * scale, tree), norm


class TrainState(NamedTuple):
    params: dict          # a param_tree of plain tensors
    opt_state: tuple      # AdamWState | AdafactorState
    step: Tensor          # int32, on the parameters' device


def _optimizer(cfg: ArchConfig):
    return adafactor if cfg.optimizer == "adafactor" else adamw


def init_train_state(cfg: ArchConfig, params) -> TrainState:
    """The state over ``params`` (a ``Decoder``, whose tensors it shares,
    or a ``param_tree``), with the optimizer ``cfg.optimizer`` names."""
    if isinstance(params, Decoder):
        params = param_tree(params)
    dev = leaves(params)[0].device
    return TrainState(params=params, opt_state=_optimizer(cfg).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(cfg: ArchConfig, *, constrain=lambda x, k: x,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0,
                    microbatches: int = 1,
                    accum_dtype=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    0-d tensors: loss, grad_norm, lr, ce and aux.

    accum_dtype: the gradient-accumulation dtype across microbatches, f32
    below 1e11 parameters and bf16 above, as in the JAX package (there,
    two params-shaped f32 buffers would not fit at arctic/jamba scale).
    """
    opt = _optimizer(cfg)
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16 if cfg.param_count() >= 1e11
                       else torch.float32)

    def grads_of(params, batch):
        live = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss, extras = loss_fn(live, cfg, batch, constrain)
        ts = leaves(live)
        gs = torch.autograd.grad(loss, ts, allow_unused=True)
        # a leaf the batch does not reach (the token embedding under
        # the audio frontend) has a zero gradient, as under jax.grad
        gs = [torch.zeros_like(t) if g is None else g
              for t, g in zip(ts, gs)]
        extras = {k: v.detach() for k, v in extras.items()}
        return loss.detach(), extras, unflatten(params, gs)

    def train_step(state: TrainState, batch: dict):
        if microbatches > 1:
            def slice_mb(x, j):
                b = x.shape[0] // microbatches
                return x[j * b:(j + 1) * b]

            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), state.params)
            for j in range(microbatches):
                mb = {k: slice_mb(v, j) for k, v in batch.items()}
                loss_j, _extras, g = grads_of(state.params, mb)
                loss = loss + loss_j
                grads = map_tree(lambda a, g: a + g.to(a.dtype), grads, g)
            loss = loss / microbatches
            grads = map_tree(lambda g: g / microbatches, grads)
            extras = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, extras, grads = grads_of(state.params, batch)

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = warmup_cosine(state.step, peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        new_params, new_opt = opt.update(grads, state.opt_state,
                                         state.params, lr=lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **extras}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step

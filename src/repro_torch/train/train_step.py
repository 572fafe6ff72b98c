"""Training step: loss, (accumulated) gradients, clipping, optimizer
update — the JAX package's ``repro.train.train_step``.

The step is a closure over the static ``ArchConfig``. The state's
parameters are a ``param_tree`` (the JAX package's layout, ``Stacked``
per-layer tensors for its stacked leaves) of plain tensors; each step
takes detached aliases of them that require gradients, so the state
itself carries no autograd graph and checkpoints, copies and restores as
a plain tree. The optimizer writes the new parameters into the state's
tensors (the ``Decoder`` they came from, if any, serves the trained
weights). Microbatches (gradient accumulation) run as a Python loop over
slices of the batch: one microbatch's activations are live at a time.

Sharded (``constrain`` from ``sharding.specs.make_constrain``, the same
step in every rank): the state holds this rank's shards
(``init_train_state(cfg, sharding.state.shard_params(...))``) and the
step takes the GLOBAL
batch, of which each rank keeps its rows (each microbatch split as the
JAX package splits it). The loss and its metrics are the global batch's
on every rank: the CE's sums over the split batch axes are psums whose
backward is the identity, so each rank's backward gives its own
tokens' contribution, and ``ShardCtx.grad_sync`` then sums every
gradient over the split axes its leaf is not sharded on. The gradient
norm sums each leaf's squares over the axes the leaf is sharded on
(every element once); Adafactor's factored means and RMS clip run over
the global leaf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Decoder, forward, param_tree
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.models.transformer import unembed_weight
from repro_torch.sharding.collectives import leaf_specs, spec_axes
from repro_torch.utils.tree import leaves, map_tree, unflatten

Tensor = torch.Tensor

AUX_LOSS_WEIGHT = 0.01
IGNORE_LABEL = -1
FUSED_CE_MIN_VOCAB = 65536


def _denominator(mask: Tensor, count) -> Tensor:
    return torch.clamp(mask.sum() if count is None else count, min=1.0)


def cross_entropy(logits: Tensor, labels: Tensor, *,
                  count=None) -> Tensor:
    """Mean next-token CE over labels != IGNORE_LABEL (f32 math).
    ``count``: the denominator, when the labels are one rank's part of a
    batch (the global number of labels counted)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = (labels != IGNORE_LABEL).float()
    return -(ll * mask).sum() / _denominator(mask, count)


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
    def forward(ctx, hidden, unembed, labels, vocab_size, chunk, count=None):
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
        ctx.counted = count is not None
        count = _denominator(mask, count)
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
        return ((gh.to(hidden.dtype).reshape(b, s, d), gw, None, None, None)
                + ((None,) if ctx.counted else ()))


def _chunk_logits(h: Tensor, unembed: Tensor, ci: int, chunk: int,
                  vocab_size: int) -> Tensor:
    """Chunk ``ci``'s f32 logits, the padded vocab columns at -1e30."""
    c0 = ci * chunk
    lg = (h @ unembed[:, c0:c0 + chunk]).float()
    if c0 + chunk > vocab_size:
        lg[:, max(vocab_size - c0, 0):] = -1e30
    return lg


def fused_unembed_ce(hidden: Tensor, unembed: Tensor, labels: Tensor, *,
                     vocab_size: int, chunk: int = 16384,
                     count=None) -> Tensor:
    """CE fused into the unembedding matmul, over vocab chunks.

    The full (tokens, V) logits never exist: each chunk computes
    hidden @ W[:, v:v+chunk], folds it into an online logsumexp (running
    max, scaled sum, label logit) and is dropped. The backward recomputes
    each chunk's logits (one extra unembed matmul of FLOPs): plain
    autograd would keep every chunk's f32 logits alive (about 1 GB at
    2048 tokens x 128,256). The gradient of ``hidden`` is summed over the
    chunks in f32 and cast once. ``count`` as in ``cross_entropy``.
    """
    extra = () if count is None else (count,)
    return _FusedUnembedCE.apply(hidden, unembed, labels, vocab_size, chunk,
                                 *extra)


def loss_fn(params, cfg: ArchConfig, batch: dict,
            constrain=None) -> Tuple[Tensor, dict]:
    """(loss, {"ce", "aux"}) of a batch; ``params`` a ``Decoder`` or its
    ``param_tree``. ``constrain``: the sharding hook (None on one device);
    sharded, ``params`` and ``batch`` are this rank's and the loss, ce and
    aux the global batch's (the CE's psum over the split axes has the
    identity for its backward)."""
    kwargs = {}
    if "embeds" in batch:
        kwargs["embeds"] = batch["embeds"]
    else:
        kwargs["tokens"] = batch["tokens"]
    if "vision_embeds" in batch:
        kwargs["vision_embeds"] = batch["vision_embeds"]
    labels = batch["labels"]
    nv = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
    sh = getattr(constrain, "sharding", None)
    count = None
    if sh is not None:
        count = sh.psum((labels != IGNORE_LABEL).float().sum(), sh.split)
    if cfg.padded_vocab >= FUSED_CE_MIN_VOCAB:
        hidden, _, aux = forward(params, cfg, return_hidden=True,
                                 constrain=constrain, **kwargs)
        ce = fused_unembed_ce(hidden[:, nv:],
                              unembed_weight(params, cfg, constrain), labels,
                              vocab_size=cfg.vocab_size, count=count)
    else:
        logits, _, aux = forward(params, cfg, constrain=constrain, **kwargs)
        ce = cross_entropy(logits[:, nv:], labels, count=count)
    if sh is not None:
        ce = sh.psum_split(ce)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def global_norm(tree, *, sharding=None, specs=None) -> Tensor:
    """The L2 norm of every leaf together. Sharded (``sharding`` a
    ``ShardCtx``, ``specs`` the tree's specs): each leaf's sum of squares
    is summed over exactly the axes the leaf is sharded on, so every
    element counts once."""
    if sharding is None:
        sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
        return torch.sqrt(sq)
    parts: dict = {}
    for x, spec in zip(leaves(tree), leaf_specs(specs)):
        axes = tuple(sorted(set(spec_axes(spec))))
        v = torch.sum(torch.square(x.float()))
        parts[axes] = parts[axes] + v if axes in parts else v
    return torch.sqrt(sum(sharding.psum(v, axes)
                          for axes, v in sorted(parts.items())))


def clip_by_global_norm(tree, max_norm: float, *, sharding=None,
                        specs=None):
    """(tree * scale, norm), scale = min(1, max_norm / (norm + 1e-9)). A
    leaf of a narrower type than the f32 scale comes back in f32, as the
    JAX package's type promotion has it."""
    norm = global_norm(tree, sharding=sharding, specs=specs)
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


def make_train_step(cfg: ArchConfig, *, constrain=None,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0,
                    microbatches: int = 1,
                    accum_dtype=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    0-d tensors: loss, grad_norm, lr, ce and aux.

    accum_dtype: the gradient-accumulation dtype across microbatches, f32
    below 1e11 parameters and bf16 above, as in the JAX package (there,
    two params-shaped f32 buffers would not fit at arctic/jamba scale).

    ``constrain``: None on one device; from ``make_constrain`` for the
    sharded step (see the module docstring).
    """
    opt = _optimizer(cfg)
    sh = getattr(constrain, "sharding", None)
    specs = sh.param_specs(cfg) if sh is not None else None
    shard_kw = {"sharding": sh, "specs": specs} if sh is not None else {}
    opt_kw = shard_kw if opt is adafactor else {}
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
        if sh is not None:
            gs = sh.grad_sync(gs, leaf_specs(specs))
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
                if sh is not None:
                    mb = sh.shard_batch(mb)
                loss_j, _extras, g = grads_of(state.params, mb)
                loss = loss + loss_j
                grads = map_tree(lambda a, g: a + g.to(a.dtype), grads, g)
            loss = loss / microbatches
            grads = map_tree(lambda g: g / microbatches, grads)
            extras = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            if sh is not None:
                batch = sh.shard_batch(batch)
            loss, extras, grads = grads_of(state.params, batch)

        grads, gnorm = clip_by_global_norm(grads, grad_clip, **shard_kw)
        lr = warmup_cosine(state.step, peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        new_params, new_opt = opt.update(grads, state.opt_state,
                                         state.params, lr=lr, **opt_kw)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **extras}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step

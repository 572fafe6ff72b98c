"""Open-set recognition with the paper's classifier on LM features, on
the PyTorch port — the OCSSVM slab head as a first-class framework
feature (the counterpart of ``examples/lm_anomaly.py``).

1. Briefly train a small LM on "in-distribution" synthetic text (narrow
   token marginal).
2. Pool final hidden states as features.
3. Fit the slab with the blocked SMO solver.
4. Score held-out ID and OOD sequences; report separation (AUC).

    PYTHONPATH=src python examples/torch_lm_anomaly.py [--device cpu]

Tokens come from numpy generators with fixed seeds and the parameters
from a seeded ``torch.Generator``, so the numbers are not the JAX
example's (``jax.random`` draws).
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import LayerSpec
from repro_torch.core import SlabSpec, fit_head, rbf
from repro_torch.models.transformer import forward, init_params
from repro_torch.train.train_step import init_train_state, make_train_step

SPEC = SlabSpec(nu1=0.2, nu2=0.1, eps=0.3, kernel=rbf(gamma=0.05))
STEPS, BATCH, SEQ = 60, 16, 32


def lm_config():
    """The example's small llama (4 layers, d_model 128, f32)."""
    return dataclasses.replace(
        get_arch("llama3.2-3b"), n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        layer_pattern=(LayerSpec("full"),), param_dtype="float32",
        remat="none")


def id_batch(seed, n: int) -> np.ndarray:
    """In-distribution: a narrow token range."""
    return np.random.default_rng(seed).integers(0, 256, (n, SEQ),
                                                dtype=np.int32)


def ood_batch(seed, n: int, vocab_size: int) -> np.ndarray:
    """OOD: tokens from the other end of the vocab."""
    return np.random.default_rng(seed).integers(
        vocab_size - 256, vocab_size, (n, SEQ), dtype=np.int32)


def train_batch(i: int) -> dict:
    """Step ``i``'s next-token batch (numpy)."""
    toks = id_batch([0, i], BATCH)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def main(device=None, steps: int = STEPS) -> dict:
    """Train, pool, fit and score on ``device`` (default: the CUDA card);
    returns the numbers it prints, the features and the head."""
    dev = resolve_device(device)
    cfg = lm_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    # 1. brief LM training on ID data
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, peak_lr=3e-3, warmup_steps=10,
                           total_steps=steps)
    losses = []
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in train_batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    print(f"LM trained: final loss {losses[-1]:.3f}")

    # 2. features = the top-64 logit dims, mean pooled (a cheap proxy of
    # the backbone's features, as in the JAX example)
    @torch.no_grad()
    def features(tokens: np.ndarray) -> np.ndarray:
        logits, _, _ = forward(state.params, cfg,
                               tokens=torch.as_tensor(tokens, device=dev))
        return logits[..., :64].mean(dim=1).cpu().numpy()

    F_train = features(id_batch(1, 256))
    F_id = features(id_batch(2, 128))
    F_ood = features(ood_batch(3, 128, cfg.vocab_size))

    # 3. slab head (paper's classifier, blocked SMO)
    head = fit_head(F_train, SPEC, solver="blocked", P=8, tol=1e-3,
                    device=dev)
    print(f"head fitted: iters={int(head.result.iters)} "
          f"converged={bool(head.result.converged)}")

    # 4. separation
    s_id = head.score(F_id).cpu().numpy()
    s_ood = head.score(F_ood).cpu().numpy()
    auc = float(np.mean(s_id[:, None] > s_ood[None, :]))
    print(f"ID score mean {s_id.mean():+.4f} | OOD score mean "
          f"{s_ood.mean():+.4f} | AUC = {auc:.3f}")
    return {"losses": losses, "head_iters": int(head.result.iters),
            "head_converged": bool(head.result.converged), "auc": auc,
            "head": head, "features": {"train": F_train, "id": F_id,
                                       "ood": F_ood},
            "scores": {"id": s_id, "ood": s_ood}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args()
    main(args.device)

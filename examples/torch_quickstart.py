"""Quickstart on the PyTorch port: train a One-Class Slab SVM with the
paper's SMO, then with the blocked solver, and score new points (the
counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The blocked fit asks for ``gram_mode="pallas"``: the fused ``fupdate``
kernel updates the f-cache every iteration (on the card; on the CPU its
plain PyTorch version). The toy rows come from ``repro_torch.data.
make_toy`` with a seed, so they are not the JAX example's (numpy draws,
not ``jax.random``).
"""
import argparse

import torch

import repro_torch
from repro_torch.api import resolve_device
from repro_torch.configs.ocssvm_paper import PAPER_SPEC
from repro_torch.core import SlabSpec, mcc, rbf, with_quantile_offsets
from repro_torch.data import make_toy

SPEC = SlabSpec(nu1=0.3, nu2=0.05, eps=0.4, kernel=rbf(gamma=0.8))


def main(device=None, m: int = 1000, queries: int = 200) -> dict:
    """Fit and score on ``device`` (default: the CUDA card); returns the
    numbers it prints."""
    dev = resolve_device(device)
    X, y = make_toy(0, m)

    print("== paper-faithful SMO (Algorithm 1, paper's linear protocol) ==")
    res = repro_torch.fit(X, PAPER_SPEC, strategy="paper", tol=1e-3,
                          device=dev)
    paper_mcc = float(mcc(y, res.model.predict(torch.as_tensor(
        X, device=dev))))
    print(f"iters={int(res.iters)} converged={bool(res.converged)} "
          f"rho1={float(res.model.rho1):.4f} rho2={float(res.model.rho2):.4f}")
    print(f"train MCC = {paper_mcc:.3f} (paper Table 1 reports 0.13 at "
          f"m=1000)")

    print("== blocked SMO (engine, P=16, RBF, fused fupdate kernel) ==")
    res_b = repro_torch.fit(X, SPEC, P=16, tol=1e-3, gram_mode="pallas",
                            device=dev)
    model = with_quantile_offsets(res_b.model)   # primal-consistent slab
    blocked_mcc = float(mcc(y, model.predict(torch.as_tensor(X,
                                                             device=dev))))
    print(f"iters={int(res_b.iters)} converged={bool(res_b.converged)} "
          f"MCC={blocked_mcc:.3f}")

    # score new points
    Xq, yq = make_toy(1, queries)
    q = torch.as_tensor(Xq, device=dev)
    scores = model.decision_function(q)
    acc = float((model.predict(q).cpu() == torch.as_tensor(yq)).float()
                .mean())
    print(f"held-out: accuracy={acc:.3f} scores range "
          f"[{float(scores.min()):.3f}, {float(scores.max()):.3f}]")
    return {"paper_iters": int(res.iters),
            "paper_converged": bool(res.converged),
            "paper_rho": (float(res.model.rho1), float(res.model.rho2)),
            "paper_mcc": paper_mcc,
            "blocked_iters": int(res_b.iters),
            "blocked_converged": bool(res_b.converged),
            "blocked_mcc": blocked_mcc, "heldout_accuracy": acc,
            "scores": scores.cpu().numpy()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    ap.add_argument("--m", type=int, default=1000)
    args = ap.parse_args()
    main(args.device, args.m)

"""Matthews Correlation Coefficient — the paper's evaluation metric."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mcc(y_true, y_pred) -> Tensor:
    """MCC for labels in {-1, +1}, as an f32 0-d tensor. Returns 0 when
    any marginal is empty. Accepts tensors or array-likes; the result
    lies on ``y_pred``'s device when it is a tensor."""
    yp = torch.as_tensor(y_pred)
    yt = torch.as_tensor(y_true, device=yp.device) > 0
    yp = yp > 0
    tp = torch.sum(yt & yp).to(torch.float32)
    tn = torch.sum(~yt & ~yp).to(torch.float32)
    fp = torch.sum(~yt & yp).to(torch.float32)
    fn = torch.sum(yt & ~yp).to(torch.float32)
    num = tp * tn - fp * fn
    den = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return torch.where(den > 0, num / den, torch.zeros_like(den))

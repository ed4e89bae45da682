"""DDPM training steps of the UNet: x_t = sqrt(acp[t]) x0 + sqrt(1 - acp[t])
noise, the mean squared error of the predicted epsilon, its gradient, and
Adam (beta 0.9 / 0.999, eps 1e-8, bias-corrected), in float32.

``train_steps`` returns what the benchmark compares: each step's loss,
each leaf's first gradient, each leaf's parameters after the steps, and
the first gradient over each half of the first batch (the mean over that
half's rows), which a gradient that left out half the batch follows.
Rows are taken `chunk` at a time, the gradient of the batch mean summed
over them, so that a large batch fits."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .ops import FP32, Ops
from .unet import unet_forward


def ddpm_loss(p, cfg, acp, x0, t, noise, ops: Ops = FP32) -> torch.Tensor:
    a = acp[t].view((-1,) + (1,) * (x0.dim() - 1))
    x_t = a.sqrt() * x0 + (1 - a).sqrt() * noise
    return ((unet_forward(p, cfg, x_t, t, ops) - noise) ** 2).mean()


def train_steps(p0: Dict[str, torch.Tensor], cfg: dict, acp: torch.Tensor,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                lr: float, ops: Ops = FP32, chunk: int = 128,
                rows: int = 0) -> Tuple[List[float], Dict[str, torch.Tensor],
                                        Dict[str, torch.Tensor],
                                        Tuple[Dict[str, torch.Tensor], ...]]:
    """(losses, first gradient by leaf, parameters after the last step, the
    first gradient by leaf over each half of the first batch) of Adam steps
    from p0 on `batches` of (x0, t, noise). `rows` > 0 trains on the first
    `rows` rows of each batch only (a planted fault)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, halves = [], None, None
    for step, (x0, t, noise) in enumerate(batches, start=1):
        if rows:
            x0, t, noise = x0[:rows], t[:rows], noise[:rows]
        leaves = {k: w.requires_grad_() for k, w in p.items()}
        n = x0.shape[0]
        bounds = ((0, n // 2), (n // 2, n))
        by_half = [{k: torch.zeros_like(w) for k, w in p.items()} for _ in bounds]
        total = 0.0
        for h, (lo, hi) in enumerate(bounds):
            for s in range(lo, hi, chunk):
                sl = slice(s, min(s + chunk, hi))
                share = x0[sl].shape[0] / n
                loss = ddpm_loss(leaves, cfg, acp, x0[sl], t[sl], noise[sl], ops) * share
                for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
                    by_half[h][k] += g
                total += float(loss.detach())
        grads = {k: by_half[0][k] + by_half[1][k] for k in p}
        losses.append(total)
        if first is None:
            first = grads
            halves = tuple({k: g * (n / (hi - lo)) for k, g in h.items()}
                           for h, (lo, hi) in zip(by_half, bounds))
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v2[k] / (1 - b2 ** step)
                p[k] = (p[k] - lr * m_hat / (v_hat.sqrt() + eps)).detach()
    return losses, first, p, halves

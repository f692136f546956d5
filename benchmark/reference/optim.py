"""The optimizer of a training step, written out plainly.

The gradient is scaled to global norm 1 when its norm is 1 or more, its
non-finite entries are set to 0, weight decay adds wd·p, then Adam (β
0.9 and 0.999, ε 1e−8 outside the root, bias-corrected) moves each entry
by the rate of the cosine schedule at the count of completed steps. A
step whose energy-decay term is not finite changes nothing. The runtime
form of the schedule (``runtime``) is eta_min + (lr − eta_min)·c, the
static one lr·((1 − eta_min/lr)·c + eta_min/lr), c = (1 + cos(π·min(n,
T_max)/T_max))/2; with the runtime form the decay is always added.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def rate(h: dict, n: int) -> float:
    c = 0.5 * (1 + math.cos(math.pi * min(n, h["T_max"]) / h["T_max"]))
    if h["runtime"]:
        return h["eta_min"] + (h["lr"] - h["eta_min"]) * c
    a = h["eta_min"] / h["lr"] if h["lr"] else 0.0
    return h["lr"] * ((1 - a) * c + a)


def clipped(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], h: dict) -> Dict[str, torch.Tensor]:
    """What Adam receives: the clipped, finite gradient plus the decay."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    out = {}
    for n, g in grads.items():
        u = g if norm < 1.0 else g / norm
        u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
        if h["runtime"] or h["weight_decay"]:
            u = u + h["weight_decay"] * params[n]
        out[n] = u
    return out


def adam(params, mu, nu, u, n: int, h: dict) -> Tuple[dict, dict, dict]:
    """One Adam step at completed-step count n: (params, mu, nu)."""
    lr = rate(h, n)
    bc1, bc2 = 1 - 0.9 ** (n + 1), 1 - 0.999 ** (n + 1)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        m = 0.9 * mu[k] + 0.1 * u[k]
        v = 0.999 * nu[k] + 0.001 * u[k] * u[k]
        new_p[k] = params[k] - lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        new_m[k], new_v[k] = m, v
    return new_p, new_m, new_v

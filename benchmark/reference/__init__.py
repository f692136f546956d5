"""The plain reference of the benchmark: the AVR field, its renderer, its
criterion and its optimizer in float32 PyTorch, with TF32 off.

It imports nothing of the program under test and takes nothing the
program made: the benchmark hands it the configuration (a dict), the
weights it drew, and the batches and ray directions it drew. It is slow
and keeps little in memory: rays go in blocks, and a training step's
gradient is pulled back block by block.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import losses, optim
from benchmark.reference import render as render_ref
from benchmark.reference.field import Field
from benchmark.reference.precision import FP32, strict_fp32


def hparams(cfg: dict, trial: Dict[str, float] = None) -> dict:
    """The optimizer's and the criterion's settings: the configuration's,
    or with a trial's runtime values (``trial``) over them."""
    tc, rc = cfg["train"], cfg["render"]
    h = {k: float(tc[k]) for k in losses.WEIGHTS}
    h.update(lr=float(tc["lr"]), eta_min=float(tc["eta_min"]), T_max=max(1, int(tc["T_max"])),
             weight_decay=float(tc["weight_decay"]), runtime=False)
    if trial is not None:
        h.update({k: float(v) for k, v in trial.items()}, runtime=True)
    h["das"] = {"reg": float(tc["das_reg_loss_weight"]) > 0, "ce": float(tc["das_ce_loss_weight"]) > 0,
                "fs": float(rc["fs"]), "speed": float(rc["speed"]), "beta": float(tc["beta"])}
    return h


class Reference:
    """The reference for one configuration on one device."""

    def __init__(self, cfg: dict, device, precision: str = FP32, ray_block: int = 256):
        self.cfg = cfg
        self.field = Field(cfg)
        self.geo = render_ref.Geometry(cfg, self.field.T, device)
        self.precision = precision
        self.ray_block = ray_block

    def render(self, params, batch, dirs) -> torch.Tensor:
        """Spectra [bs, F, 2] of one batch."""
        with strict_fp32():
            return render_ref.render(params, self.field, self.geo, batch, dirs, self.precision, self.ray_block)

    def train(self, params: Dict[str, torch.Tensor], batches: List[dict], dirs: List[torch.Tensor],
              h: dict, grad_fault=None) -> dict:
        """Steps from ``params`` with zero moments, one per batch: each step's
        total loss and terms, the first step's spectra and its clipped
        gradient as Adam receives it, and the params after the last step.
        ``grad_fault``, where given, rewrites each step's gradient (a fault
        planted for its readings)."""
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        out = {"loss": [], "terms": []}
        with strict_fp32():
            for n, (batch, d) in enumerate(zip(batches, dirs)):
                def loss_fn(pred):
                    terms = losses.criterion(pred, batch["wave"], h, h["das"])
                    return terms.total, terms

                terms, grads, pred = render_ref.loss_and_grads(
                    params, self.field, self.geo, batch, d, self.precision, self.ray_block, loss_fn)
                out["loss"].append(float(terms.total.detach()))
                out["terms"].append({k: float(v.detach()) for k, v in terms.values.items()})
                if grad_fault is not None:
                    grads = grad_fault(grads)
                u = optim.clipped(grads, params, h)
                if n == 0:
                    out["first_update"], out["first_pred"] = u, pred
                if torch.isfinite(terms.values["energy"]):
                    params, mu, nu = optim.adam(params, mu, nu, u, len(out["loss"]) - 1 - out.get("skipped", 0), h)
                else:
                    out["skipped"] = out.get("skipped", 0) + 1
                del grads
        out["params"] = params
        return out

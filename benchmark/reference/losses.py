"""The AVR criterion bank, written out plainly.

Terms on a predicted and a measured spectrum [bs, F, 2], each times its
weight: L1 of the real and of the imaginary parts; L1 of the magnitudes;
L1 of the cosine and of the sine of the phases; L1 of the impulse
responses (inverse rFFT); L1 of the energy-decay curves; the
multi-resolution STFT loss; and on whole 8-microphone groups the
delay-and-sum direction terms (a regression on the soft-argmax angle and
a cross-entropy on the measured peak).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

TERMS = ("spec", "amplitude", "angle", "time", "energy", "multi_stft", "das_reg", "das_ce")
WEIGHTS = ("spec_loss_weight", "amplitude_loss_weight", "angle_loss_weight", "time_loss_weight",
           "energy_loss_weight", "multistft_loss_weight", "das_reg_loss_weight", "das_ce_loss_weight")


class Terms(NamedTuple):
    values: Dict[str, torch.Tensor]

    @property
    def total(self) -> torch.Tensor:
        return sum(self.values[t] for t in TERMS)


def _l1(a, b):
    return (a - b).abs().mean()


def stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """Centred STFT [..., n_fft/2 + 1, frames] of x [..., T]: frames of
    n_fft samples every ``hop``, the signal mirrored by n_fft/2 at both
    ends (repeatedly where the signal is shorter), the window centred in
    the frame."""
    T = x.shape[-1]
    src = np.pad(np.arange(T), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(src) - n_fft) // hop
    idx = src[np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]]
    left = (n_fft - window.shape[0]) // 2
    win = torch.zeros(n_fft, dtype=x.dtype, device=x.device)
    win[left:left + window.shape[0]] = window
    frames = x[..., torch.as_tensor(idx, device=x.device)] * win
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def hann(n: int, device) -> torch.Tensor:
    k = np.arange(n)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * k / n), dtype=torch.float32, device=device)


def multi_stft(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multi-resolution STFT loss of x against y [bs, T] (spectral
    convergence ‖|Y|−|X|‖/‖|Y|‖, log-magnitude L1 and magnitude L1 at four
    resolutions; magnitudes clamped at 1e−8 before the root), averaged."""
    total = 0.0
    for n_fft, win, hop in ((512, 300, 60), (256, 150, 30), (128, 75, 8), (64, 30, 4)):
        w = hann(win, x.device)
        xm = torch.sqrt(torch.clamp(stft(x, n_fft, hop, w).abs() ** 2, min=1e-8))
        ym = torch.sqrt(torch.clamp(stft(y, n_fft, hop, w).abs() ** 2, min=1e-8))
        sc = (torch.linalg.norm((ym - xm).flatten(-2), dim=-1) / torch.linalg.norm(ym.flatten(-2), dim=-1)).mean()
        total = total + sc + (torch.log(xm) - torch.log(ym)).abs().mean() + (xm - ym).abs().mean()
    return total / 4


def decay_curve(x: torch.Tensor) -> torch.Tensor:
    """log10 of the backward-summed squared STFT frame energies (n_fft 256,
    rectangular window), relative to the first frame."""
    energy = (stft(x, 256, 64, torch.ones(256, device=x.device)).abs() ** 2).sum(dim=-2)
    back = torch.flip(torch.cumsum(torch.flip(energy, dims=(-1,)) ** 2, dim=-1), dims=(-1,))
    curve = torch.log10(back + 1e-9)
    return curve - curve[..., :1]


def steered_power(spec: torch.Tensor, fs: float, c: float) -> torch.Tensor:
    """Normalised delay-and-sum power [groups, 360] of 8-mic circular
    groups spec [groups, 8, F] (complex): the impulse responses cut to 512
    samples, mics on the unit circle from π/2, one look per degree, the
    power normalised over the looks at each frequency and summed."""
    M = spec.shape[-2]
    x = torch.fft.irfft(spec, dim=-1)
    x = x[..., :512] if x.shape[-1] >= 512 else torch.nn.functional.pad(x, (0, 512 - x.shape[-1]))
    X = torch.fft.rfft(x, dim=-1)
    f = torch.as_tensor(np.fft.rfftfreq(512, 1.0 / fs), dtype=torch.float32, device=spec.device)
    phi = np.pi / 2 + 2 * np.pi * np.arange(M) / M
    mic = np.stack([np.cos(phi), np.sin(phi)], -1)
    look = np.deg2rad(np.arange(360.0))
    u = np.stack([np.cos(look), np.sin(look)], -1)
    tau = torch.as_tensor(u @ (mic - mic.mean(0)).T / c, dtype=torch.float32, device=spec.device)  # [360, M]
    steer = torch.exp(-2j * np.pi * tau[:, :, None] * f)  # [360, M, F]
    beam = (X[:, None, :, :] * steer[None]).sum(dim=2) / M  # [groups, 360, F]
    power = beam.abs() ** 2
    power = power / (power.sum(dim=1, keepdim=True) + 1e-8)
    return power.sum(dim=-1)


def criterion(pred: torch.Tensor, wave: torch.Tensor, w: Dict[str, float], das: Dict[str, float]) -> Terms:
    """The weighted terms for spectra pred and wave [bs, F, 2]. ``w`` maps
    each weight name of WEIGHTS to its value; ``das`` holds fs, speed, beta
    and which direction terms exist (their configured weights > 0)."""
    pc = torch.complex(pred[..., 0], pred[..., 1])
    oc = torch.complex(wave[..., 0], wave[..., 1])
    pt, ot = torch.fft.irfft(pc, dim=-1), torch.fft.irfft(oc, dim=-1)
    pa, oa = torch.angle(pc), torch.angle(oc)
    v = {
        "spec": (_l1(pc.real, oc.real) + _l1(pc.imag, oc.imag)) * w["spec_loss_weight"],
        "amplitude": _l1(pc.abs(), oc.abs()) * w["amplitude_loss_weight"],
        "angle": (_l1(torch.cos(pa), torch.cos(oa)) + _l1(torch.sin(pa), torch.sin(oa))) * w["angle_loss_weight"],
        "time": _l1(ot, pt) * w["time_loss_weight"],
        "energy": _l1(decay_curve(ot), decay_curve(pt)) * w["energy_loss_weight"],
        "multi_stft": multi_stft(ot, pt) * w["multistft_loss_weight"],
    }
    zero = torch.zeros((), device=pred.device)
    v["das_reg"], v["das_ce"] = zero, zero
    if das["reg"] or das["ce"]:
        g = pc.shape[0] // 8
        pp = steered_power(pc.reshape(g, 8, -1), das["fs"], das["speed"])
        po = steered_power(oc.reshape(g, 8, -1), das["fs"], das["speed"])
        if das["ce"]:
            peak = po.argmax(dim=-1)
            ce = torch.logsumexp(pp, dim=-1) - pp.gather(-1, peak[:, None])[:, 0]
            v["das_ce"] = ce.mean() * w["das_ce_loss_weight"]
        if das["reg"]:
            ang = torch.deg2rad(torch.arange(360.0, device=pred.device))
            a_p = (torch.softmax(das["beta"] * pp, dim=-1) * ang).sum(-1)
            a_o = (torch.softmax(das["beta"] * po, dim=-1) * ang).sum(-1)
            v["das_reg"] = ((torch.sin(a_p) - torch.sin(a_o)).abs()
                            + (torch.cos(a_p) - torch.cos(a_o)).abs()).mean() * w["das_reg_loss_weight"]
    return Terms(v)

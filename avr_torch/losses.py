"""Training criterion: the AVR loss bank (port of ``avr_tpu/losses.py``).

Spectral L1 (real+imag), amplitude L1, phase sin/cos L1, time-domain L1,
energy-decay-curve L1, the multi-resolution STFT loss (auraloss
semantics), and the delay-and-sum beamforming losses. Reference quirks
are kept for parity: the energy-decay curve squares the already-squared
spectral energy, each 8-row block of the batch beamforms as one circular
8-mic group, and the magnitude clamp is eps = 1e-8.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from avr_torch.config import RenderConfig, TrainConfig
from avr_torch.ops import stft as stft_lib


def to_complex(x: torch.Tensor) -> torch.Tensor:
    """Accept [..., F, 2] real/imag stacks or complex tensors."""
    if torch.is_complex(x):
        return x
    return torch.complex(x[..., 0], x[..., 1])


@dataclass(frozen=True)
class MRSTFTConfig:
    fft_sizes: Tuple[int, ...] = (512, 256, 128, 64)
    win_lengths: Tuple[int, ...] = (300, 150, 75, 30)
    hop_sizes: Tuple[int, ...] = (60, 30, 8, 4)
    w_sc: float = 1.0
    w_log_mag: float = 1.0
    w_lin_mag: float = 1.0
    eps: float = 1e-8


# The 3-resolution variant used by the evaluation metrics
# (reference/utils/metric.py:31).
MRSTFT_METRIC = MRSTFTConfig(
    fft_sizes=(512, 256, 128), win_lengths=(300, 150, 75), hop_sizes=(60, 30, 8)
)


def multi_resolution_stft_loss(
    x: torch.Tensor, y: torch.Tensor, cfg: MRSTFTConfig = MRSTFTConfig()
) -> torch.Tensor:
    """auraloss MultiResolutionSTFTLoss(x=input, y=target), mean-reduced."""
    x2 = x.reshape(-1, x.shape[-1])
    y2 = y.reshape(-1, y.shape[-1])
    total = 0.0
    for n_fft, win, hop in zip(cfg.fft_sizes, cfg.win_lengths, cfg.hop_sizes):
        w = stft_lib.hann_window(win, x2.dtype, x2.device)
        xm = stft_lib.stft_magnitude(x2, n_fft, hop, win, w, eps=cfg.eps)
        ym = stft_lib.stft_magnitude(y2, n_fft, hop, win, w, eps=cfg.eps)
        loss = 0.0
        if cfg.w_sc:
            fro = lambda a: torch.sqrt(torch.sum(a**2, dim=(-2, -1)))  # noqa: E731
            loss = loss + cfg.w_sc * torch.mean(fro(ym - xm) / fro(ym))
        if cfg.w_log_mag:
            loss = loss + cfg.w_log_mag * torch.mean(torch.abs(torch.log(xm) - torch.log(ym)))
        if cfg.w_lin_mag:
            loss = loss + cfg.w_lin_mag * torch.mean(torch.abs(xm - ym))
        total = total + loss
    return total / len(cfg.fft_sizes)


@functools.lru_cache(maxsize=None)
def _rfft_freqs(n_fft: int, fs: float, device) -> torch.Tensor:
    """fp32 ``np.fft.rfftfreq(n_fft, 1/fs)`` on ``device``, built once per
    arguments and shared (``stft.hann_window`` says why)."""
    return torch.as_tensor(np.fft.rfftfreq(n_fft, 1.0 / fs), dtype=torch.float32, device=device)


def beamforming_power(
    sig: torch.Tensor, fs: float, sound_speed: float, n_fft: int = 512, n_angles: int = 360
) -> torch.Tensor:
    """Spatial spectrum of M-mic circular groups: [..., M, F_in] → [..., n_angles].

    irfft → rfft(n=512), unit-circle mic positions starting at φ₀=π/2,
    frequency-domain delay-and-sum, per-frequency power normalization,
    sum over frequency. Leading dims are independent groups.
    """
    sig = to_complex(sig)
    M = sig.shape[-2]
    dev = sig.device
    time_sig = torch.fft.irfft(sig, dim=-1)
    T = time_sig.shape[-1]
    if T >= n_fft:
        X = torch.fft.rfft(time_sig[..., :n_fft], dim=-1)
    else:
        X = torch.fft.rfft(torch.nn.functional.pad(time_sig, (0, n_fft - T)), dim=-1)
    freqs = _rfft_freqs(n_fft, fs, dev)

    mic_angles = torch.linspace(math.pi / 2, math.pi / 2 + 2 * math.pi, M + 1, device=dev)[:-1]
    mic_pos = torch.stack([torch.cos(mic_angles), torch.sin(mic_angles)], dim=-1)
    mic_pos = mic_pos - torch.mean(mic_pos, dim=0)

    thetas = torch.deg2rad(torch.arange(0.0, float(n_angles), 1.0, device=dev))
    u = torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)  # [K, 2]
    delays = (u @ mic_pos.T) / sound_speed  # [K, M]
    phase = torch.exp((-1j * 2 * math.pi * delays[:, :, None]) * freqs[None, None, :])

    beam = torch.einsum("...mf,kmf->...kf", X, phase) / M
    power = torch.abs(beam) ** 2
    power = power / (torch.sum(power, dim=-2, keepdim=True) + 1e-8)
    return torch.sum(power, dim=-1)  # [..., K]


class LossBundle(NamedTuple):
    """Weighted loss terms."""

    spec: torch.Tensor
    amplitude: torch.Tensor
    angle: torch.Tensor
    time: torch.Tensor
    energy: torch.Tensor
    multi_stft: torch.Tensor
    das_reg: torch.Tensor
    das_ce: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return (
            self.spec + self.amplitude + self.angle + self.time
            + self.energy + self.multi_stft + self.das_reg + self.das_ce
        )

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self._fields, self))


@dataclass(frozen=True)
class CriterionConfig:
    spec_loss_weight: float = 1.0
    amplitude_loss_weight: float = 0.5
    angle_loss_weight: float = 0.5
    time_loss_weight: float = 100.0
    energy_loss_weight: float = 5.0
    multistft_loss_weight: float = 1.0
    das_reg_loss_weight: float = 0.0
    das_ce_loss_weight: float = 0.0
    beta: float = 100.0
    fs: int = 16000
    speed: float = 343.8
    # microphones per beamforming group: batches of G·8 beamform G groups
    das_group_size: int = 8

    @classmethod
    def from_configs(cls, tc: TrainConfig, rc: RenderConfig) -> "CriterionConfig":
        return cls(
            spec_loss_weight=tc.spec_loss_weight,
            amplitude_loss_weight=tc.amplitude_loss_weight,
            angle_loss_weight=tc.angle_loss_weight,
            time_loss_weight=tc.time_loss_weight,
            energy_loss_weight=tc.energy_loss_weight,
            multistft_loss_weight=tc.multistft_loss_weight,
            das_reg_loss_weight=tc.das_reg_loss_weight,
            das_ce_loss_weight=tc.das_ce_loss_weight,
            beta=tc.beta,
            fs=rc.fs,
            speed=rc.speed,
        )


def energy_decay_curve(time_sig: torch.Tensor) -> torch.Tensor:
    """log10 reversed-cumsum STFT spectral energy, first-bin normalized
    (the energy is squared AGAIN inside the cumsum, as in the reference)."""
    spec = torch.abs(stft_lib.stft(time_sig, n_fft=256))  # [..., F, frames]
    spec_energy = torch.sum(spec**2, dim=-2)  # [..., frames]
    rev = torch.flip(spec_energy, dims=(-1,)) ** 2
    curve = torch.log10(torch.flip(torch.cumsum(rev, dim=-1), dims=(-1,)) + 1e-9)
    return curve - curve[..., :1]


def criterion(
    pred_sig: torch.Tensor, ori_sig: torch.Tensor, cfg: CriterionConfig, weights=None
) -> Tuple[LossBundle, torch.Tensor, torch.Tensor]:
    """The weighted loss bank. pred_sig/ori_sig: [bs, F, 2] or complex [bs, F].
    Returns (LossBundle, ori_time, pred_time).

    ``weights``: runtime overrides of the loss weights (0-d tensors keyed by
    the CriterionConfig field name; other keys are ignored), as the JAX
    package's ``criterion(..., weights=)`` takes them. Whether the DAS branch
    exists still comes from ``cfg``: a zero runtime weight on an active
    branch multiplies it by zero.
    """
    def w(name):
        return weights[name] if weights is not None and name in weights else getattr(cfg, name)

    pred_c = to_complex(pred_sig)
    ori_c = to_complex(ori_sig)
    l1 = lambda a, b: torch.mean(torch.abs(a - b))  # noqa: E731

    pred_time = torch.fft.irfft(pred_c, dim=-1)
    ori_time = torch.fft.irfft(ori_c, dim=-1)

    spec = (l1(pred_c.real, ori_c.real) + l1(pred_c.imag, ori_c.imag)) * w("spec_loss_weight")
    amplitude = l1(torch.abs(pred_c), torch.abs(ori_c)) * w("amplitude_loss_weight")
    pa, oa = torch.angle(pred_c), torch.angle(ori_c)
    angle = (l1(torch.cos(pa), torch.cos(oa)) + l1(torch.sin(pa), torch.sin(oa))) * w("angle_loss_weight")
    time = l1(ori_time, pred_time) * w("time_loss_weight")
    energy = l1(energy_decay_curve(ori_time), energy_decay_curve(pred_time)) * w("energy_loss_weight")
    multi = (
        multi_resolution_stft_loss(ori_time[:, None, :], pred_time[:, None, :])
        * w("multistft_loss_weight")
    )

    zero = torch.zeros((), dtype=pred_time.dtype, device=pred_time.device)
    das_reg, das_ce = zero, zero
    if cfg.das_reg_loss_weight > 0 or cfg.das_ce_loss_weight > 0:
        g = cfg.das_group_size
        bs = pred_c.shape[0]
        if bs % g != 0:
            raise ValueError(
                f"DAS losses need the batch to be whole {g}-mic groups; got batch_size={bs}"
            )
        power_pred = beamforming_power(pred_c.reshape(bs // g, g, -1), cfg.fs, cfg.speed)  # [G, K]
        power_ori = beamforming_power(ori_c.reshape(bs // g, g, -1), cfg.fs, cfg.speed)
        if cfg.das_ce_loss_weight > 0:
            target = torch.argmax(power_ori, dim=-1)  # [G]
            picked = torch.gather(power_pred, -1, target[:, None])[:, 0]
            ce = torch.logsumexp(power_pred, dim=-1) - picked
            das_ce = torch.mean(ce) * w("das_ce_loss_weight")
        if cfg.das_reg_loss_weight > 0:
            angles = torch.deg2rad(torch.arange(0.0, 360.0, 1.0, device=pred_c.device))
            wp = torch.softmax(cfg.beta * power_pred, dim=-1)
            wo = torch.softmax(cfg.beta * power_ori, dim=-1)
            pred_ang = torch.sum(wp * angles, dim=-1)
            true_ang = torch.sum(wo * angles, dim=-1)
            das_reg = torch.mean(
                torch.abs(torch.sin(pred_ang) - torch.sin(true_ang))
                + torch.abs(torch.cos(pred_ang) - torch.cos(true_ang))
            ) * w("das_reg_loss_weight")

    return (
        LossBundle(spec, amplitude, angle, time, energy, multi, das_reg, das_ce),
        ori_time,
        pred_time,
    )

"""Inputs drawn from the seed: batches, ray directions, render poses and
population trials. Everything here is the benchmark's own; the program
under test only receives what these functions return.

Batch sources (a traffic file's ``batches.source``):

* ``random_spectra``: white-noise spectra of the given scale, receivers
  and transmitters uniform in a box, transmitter headings uniform in the
  horizontal plane (complex field);
* ``image_source``: whole 8-microphone circular groups in a shoebox room,
  their impulse responses by the image-source method (a vectorised copy
  of the port's ``data/synthetic.py``: reflections up to an order, 8-tap
  Hann-windowed sinc fractional delays, 1/(4πd) spreading and a gain per
  bounce), one transmitter for the whole pool, as a Real_env set has.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 63), *stream]))


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(1 << 62)))
    return g


def ray_directions(n_azi: int, n_ele: int, generator, device) -> torch.Tensor:
    """[n_azi·n_ele + 2, 3] unit directions: an azimuth grid, each azimuth
    shifted by a uniform fraction of its step when ``generator`` is given,
    elevations uniform in cos θ over the open grid, then the two poles."""
    azi = torch.arange(n_azi, dtype=torch.float32, device=device) * (2 * math.pi / n_azi)
    if generator is not None:
        azi = azi + (2 * math.pi / n_azi) * torch.rand(n_azi, generator=generator, device=device)
    u = torch.arange(1, n_ele + 1, dtype=torch.float32, device=device) / (n_ele + 1)
    ele = torch.arccos(2.0 * u - 1.0)
    a, e = torch.meshgrid(azi, ele, indexing="ij")
    d = torch.stack([torch.cos(a) * torch.sin(e), torch.sin(a) * torch.sin(e), torch.cos(e)], -1).reshape(-1, 3)
    poles = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], device=device)
    return torch.cat([d, poles])


# ----------------------------------------------------------------------
# image-source rooms
# ----------------------------------------------------------------------
def _images(x: float, length: float, order: int):
    n = np.arange(-order, order + 1)
    pos = np.stack([2 * n * length + x, 2 * n * length - x], 1).reshape(-1)
    bounces = np.stack([2 * np.abs(n), np.abs(2 * n - 1)], 1).reshape(-1)
    return pos, bounces


def impulse_responses(room: dict, rx: np.ndarray, tx: np.ndarray, T: int, fs: float, c: float) -> np.ndarray:
    """Impulse responses [M, T] (float32) at receivers rx [M, 3] of a
    source at tx [3] in a shoebox room of ``room["size"]``."""
    size, order = room["size"], int(room["max_order"])
    axes = [_images(tx[a], size[a], order) for a in range(3)]
    px, py, pz = np.meshgrid(axes[0][0], axes[1][0], axes[2][0], indexing="ij")
    bx, by, bz = np.meshgrid(axes[0][1], axes[1][1], axes[2][1], indexing="ij")
    keep = (bx + by + bz) <= order
    src = np.stack([px[keep], py[keep], pz[keep]], -1)  # [I, 3]
    bounce = (bx + by + bz)[keep]
    d = np.linalg.norm(src[None, :, :] - rx[:, None, :], axis=-1)  # [M, I]
    delay = d / c * fs
    amp = np.sqrt(1.0 - room["absorption"]) ** bounce / (4 * np.pi * np.maximum(d, 0.1))
    amp = np.where(delay < T - 4, amp, 0.0)
    base = np.floor(delay).astype(np.int64)
    ir = np.zeros((rx.shape[0], T), np.float64)
    rows = np.broadcast_to(np.arange(rx.shape[0])[:, None], d.shape)
    for tap in range(-3, 5):
        t = base + tap
        ok = (t >= 0) & (t < T) & (amp > 0)
        tt = t - delay
        val = amp * np.sinc(tt) * 0.5 * (1 + np.cos(np.pi * tt / 4.0))
        np.add.at(ir, (rows[ok], t[ok]), val[ok])
    return ir.astype(np.float32)


def circular_array(center: np.ndarray, radius: float, m: int = 8) -> np.ndarray:
    phi = np.pi / 2 + 2 * np.pi * np.arange(m) / m
    return center[None, :] + np.stack([radius * np.cos(phi), radius * np.sin(phi), np.zeros(m)], -1)


def _uniform_in_room(r: np.random.Generator, room: dict, n: int) -> np.ndarray:
    lo = np.full(3, room["margin"])
    hi = np.asarray(room["size"]) - room["margin"]
    return lo + r.uniform(size=(n, 3)) * (hi - lo)


def image_source_pool(cfg, spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``spec["groups"]`` whole groups [G, 8, ...] and the transmitter."""
    rc, T = cfg["render"], int(cfg["model"]["signal_output_dim"])
    room = spec["room"]
    r = rng(seed, 1)
    tx = _uniform_in_room(r, room, 1)[0]
    centers = _uniform_in_room(r, room, spec["groups"])
    rx = np.concatenate([circular_array(c, room["array_radius"]) for c in centers])  # [G·8, 3]
    ir = impulse_responses(room, rx, tx, T, float(rc["fs"]), float(rc["speed"]))
    spec_c = np.fft.rfft(ir, axis=-1)
    wave = np.stack([spec_c.real, spec_c.imag], -1).astype(np.float32)
    G = spec["groups"]
    return {
        "wave": torch.as_tensor(wave.reshape(G, 8, -1, 2), device=device),
        "pos_rx": torch.as_tensor(rx.reshape(G, 8, 3).astype(np.float32), device=device),
        "pos_tx": torch.as_tensor(np.broadcast_to(tx, (G, 8, 3)).astype(np.float32).copy(), device=device),
        "ch_idx": torch.arange(8, dtype=torch.int32, device=device).repeat(G, 1),
    }


def random_spectra_pool(cfg, spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``spec["batches"]`` batches [P, bs, ...] of noise spectra."""
    bs, P = int(cfg["train"]["batch_size"]), spec["batches"]
    F = int(cfg["model"]["signal_output_dim"]) // 2 + 1
    g = torch_generator(seed, 1, device)
    lo, hi = spec["box"]
    pool = {
        "wave": torch.randn((P, bs, F, 2), generator=g, device=device) * spec["scale"],
        "pos_rx": lo + (hi - lo) * torch.rand((P, bs, 3), generator=g, device=device),
        "pos_tx": lo + (hi - lo) * torch.rand((P, bs, 3), generator=g, device=device),
    }
    if cfg["path"]["dataset_type"] == "RAF":
        a = 2 * math.pi * torch.rand((P, bs), generator=g, device=device)
        pool["rot_tx"] = torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)], -1)
    return pool


class Batches:
    """The pool of batches of a traffic file, drawn from the seed, and the
    order in which steps take them: each pass over the pool takes every
    batch once, in a fresh order drawn from the seed."""

    def __init__(self, cfg: dict, spec: dict, seed: int, device):
        bs = int(cfg["train"]["batch_size"])
        if spec["source"] == "image_source":
            if bs % 8:
                raise ValueError("image_source batches are whole 8-mic groups: batch_size must be a multiple of 8")
            pool = image_source_pool(cfg, spec, seed, device)
            per = bs // 8
            n = spec["groups"] // per
            self.pool = {k: v[: n * per].reshape(n, bs, *v.shape[2:]) for k, v in pool.items()}
        elif spec["source"] == "random_spectra":
            self.pool = random_spectra_pool(cfg, spec, seed, device)
        else:
            raise ValueError(f"unknown batch source {spec['source']!r}")
        self.n = next(iter(self.pool.values())).shape[0]
        self._rng = rng(seed, 2)
        self._order: List[int] = []

    def index(self) -> int:
        if not self._order:
            self._order = list(self._rng.permutation(self.n))
        return int(self._order.pop(0))

    def get(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: v[i] for k, v in self.pool.items()}


def render_poses(cfg: dict, spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``spec["poses"]`` requests [P, 8, ...]: a circular group at a new
    centre each, the pool's transmitter, channels 0–7."""
    room = spec["room"]
    base = image_source_pool(cfg, {**spec, "groups": 1}, seed, "cpu")
    r = rng(seed, 3)
    centers = _uniform_in_room(r, room, spec["poses"])
    rx = np.stack([circular_array(c, room["array_radius"]) for c in centers]).astype(np.float32)
    P = spec["poses"]
    return {
        "pos_rx": torch.as_tensor(rx, device=device),
        "pos_tx": base["pos_tx"][0, :1].expand(P, 8, 3).contiguous().to(device),
        "ch_idx": torch.arange(8, dtype=torch.int32, device=device).repeat(P, 1),
    }


def population_trials(spec: dict, seed: int) -> List[Dict[str, float]]:
    """The seed trial and ``spec["count"] − 1`` trials drawn from the seed
    over the runtime search space (``spec["space"]``: name → [low, high,
    "log" or "linear"]). eta_min is drawn as a ratio of lr."""
    r = rng(seed, 4)
    out = [dict(spec["seed_trial"])]
    for _ in range(spec["count"] - 1):
        t = {}
        for name, (lo, hi, scale) in sorted(spec["space"].items()):
            u = r.uniform()
            t[name] = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))) if scale == "log" else lo + u * (hi - lo)
        out.append(t)
    for t in out:
        t["eta_min"] = t["lr"] * t.pop("eta_min_ratio")
    return out

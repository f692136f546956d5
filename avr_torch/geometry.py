"""Spherical ray geometry (port of ``avr_tpu/geometry.py:22-88,102-116``).

The random azimuth offset comes from a ``torch.Generator`` (JAX used a
PRNG key); ``generator=None`` gives the deterministic grid used by tests
and evaluation. The two frameworks draw different numbers from the same
seed, so parity tests pass ``dirs`` explicitly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from avr_torch.device import resolve_device


def ray_directions(
    n_azi: int,
    n_ele: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype=torch.float32,
) -> torch.Tensor:
    """Unit directions on the sphere: azimuth×elevation grid + 2 poles.

    Azimuths are an even grid over [0, 2π); with a ``generator`` each gets
    an independent uniform offset in [0, 2π/n_azi). Elevations are uniform
    in cos(θ) over the open interior grid. Returns [n_azi·n_ele + 2, 3].
    """
    device = resolve_device(device)
    azi = torch.linspace(0.0, 2.0 * math.pi, n_azi + 1, dtype=dtype, device=device)[:-1]
    if generator is not None:
        u = torch.rand(n_azi, generator=generator, dtype=dtype, device=generator.device)
        azi = azi + (2.0 * math.pi / n_azi) * u.to(device)
    u = torch.linspace(0.0, 1.0, n_ele + 2, dtype=dtype, device=device)[1:-1]
    ele = torch.arccos(2.0 * u - 1.0)
    azi_g, ele_g = torch.meshgrid(azi, ele, indexing="ij")
    sin_ele = torch.sin(ele_g)
    dirs = torch.stack(
        [torch.cos(azi_g) * sin_ele, torch.sin(azi_g) * sin_ele, torch.cos(ele_g)],
        dim=-1,
    ).reshape(-1, 3)
    poles = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], dtype=dtype, device=device)
    return torch.cat([dirs, poles], dim=0)


def sample_distances(
    near: float, far: float, n_samples: int, device="cuda", dtype=torch.float32
) -> torch.Tensor:
    """Radial distances linspace(0,1,S)·(far−near)+near. Returns [S]."""
    device = resolve_device(device)
    return torch.linspace(0.0, 1.0, n_samples, dtype=dtype, device=device) * (far - near) + near


def ray_points(rays_o: torch.Tensor, dirs: torch.Tensor, d_vals: torch.Tensor) -> torch.Tensor:
    """Sample points along every ray: [bs,3] ⊗ [R,3] ⊗ [S] → [bs,R,S,3]."""
    return rays_o[:, None, None, :] + dirs[None, :, None, :] * d_vals[None, None, :, None]


def normalize_points(pts: torch.Tensor, xyz_min: torch.Tensor, xyz_max: torch.Tensor) -> torch.Tensor:
    """World → [−1,1] box coordinates."""
    return 2.0 * (pts - xyz_min) / (xyz_max - xyz_min) - 1.0


def quaternion_to_direction(q) -> Tuple[float, float, float]:
    """Quaternion [x,y,z,w] → planar forward direction (host math, for the
    RAF loader).

    The reference's RAF convention (reference/datasets_loader.py:223-244):
    the forward vector is projected to the horizontal plane, normalized over
    its (x,z) components, axes swapped to match the [0,2,1] position
    permutation, and negated.
    """
    x, y, z, w = (float(v) for v in q)
    fwd_x = 2.0 * (x * z + w * y)
    fwd_z = 1.0 - 2.0 * (x * x + y * y)
    norm = math.sqrt(fwd_x * fwd_x + fwd_z * fwd_z)
    return (-fwd_x / norm, -fwd_z / norm, 0.0)

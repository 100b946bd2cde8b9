"""Lighting and shading terms.

Port of `dtrenderer_tpu/ops/shading.py`; formulas in FORMULAS.md "Lighting"
(true divide + sqrt, no rsqrt). Dot products are written out as
`(x*x + y*y) + z*z`, the order the reference's 3-element reduction takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32

SHADING_NONE = "none"
SHADING_FLAT = "flat"
SHADING_GOURAUD = "gouraud"
SHADING_PHONG = "phong"


class Light(NamedTuple):
    """Directional light. direction points FROM the surface TOWARD the light."""
    direction: torch.Tensor  # f32 [3], need not be normalized
    ambient: torch.Tensor    # f32 scalar in [0,1]


def make_light(direction=(0.0, 0.0, 1.0), ambient=0.1, *, device) -> Light:
    return Light(
        direction=torch.as_tensor(direction, dtype=F32, device=device),
        ambient=torch.as_tensor(ambient, dtype=F32, device=device),
    )


def sqrt_exact(x):
    """Correctly rounded f32 sqrt on every device. ATen's CPU float sqrt is
    not correctly rounded (it differs from IEEE sqrt on ~0.6% of inputs);
    the f64 sqrt rounded once to f32 is, on the CPU and on the card alike."""
    return torch.sqrt(x.double()).to(x.dtype)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def normalize_exact(v):
    """v / sqrt(dot(v,v)); a zero vector divides by 1 and stays zero, so a
    degenerate normal is ambient-lit (FORMULAS.md guard)."""
    d = _dot3(v, v)[..., None]
    return v / sqrt_exact(torch.where(d > 0, d, torch.ones_like(d)))


def lambert(normals, light: Light):
    """max(dot(n_hat, l_hat), 0) for [..., 3] normals."""
    n = normalize_exact(normals)
    l = normalize_exact(light.direction)
    return torch.clamp_min(_dot3(n, l), 0.0)


def light_term(normals, light: Light):
    """ambient + (1-ambient) * lambert, per FORMULAS.md."""
    ndl = lambert(normals, light)
    return light.ambient + (1.0 - light.ambient) * ndl


def apply_light(rgba, term):
    """Scale rgb by the scalar light term, alpha untouched. rgba [..., 4]."""
    return torch.cat([rgba[..., :3] * term[..., None], rgba[..., 3:4]], dim=-1)

"""Texture sampling on a [th, tw, 4] texture: nearest and bilinear gathers.

Port of `dtrenderer_tpu/ops/sampling.py`; FORMULAS.md "Texture sampling"
(clamp-to-edge, v up). Op order as the reference: floor, cast to int32
(`math3d.to_i32`, XLA's conversion, so a NaN, infinite or huge coordinate
fetches the reference's texel), then clip in int.
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.utils.math3d import to_i32


def sample_nearest(tex, u, v):
    """tex f32 [th, tw, 4]; u, v f32 of one shape -> [..., 4]."""
    th, tw = tex.shape[0], tex.shape[1]
    tx = torch.clamp(to_i32(torch.floor(u * float(tw))), 0, tw - 1)
    ty = torch.clamp(to_i32(torch.floor((1.0 - v) * float(th))), 0, th - 1)
    return tex[ty.long(), tx.long()]


def _lerp2(a, b, t):
    return a + (b - a) * t


def sample_bilinear(tex, u, v):
    th, tw = tex.shape[0], tex.shape[1]
    fx = u * float(tw) - 0.5
    fy = (1.0 - v) * float(th) - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    ax = (fx - x0f)[..., None]
    ay = (fy - y0f)[..., None]
    x0i = to_i32(x0f)
    y0i = to_i32(y0f)
    x0 = torch.clamp(x0i, 0, tw - 1).long()
    x1 = torch.clamp(x0i + 1, 0, tw - 1).long()
    y0 = torch.clamp(y0i, 0, th - 1).long()
    y1 = torch.clamp(y0i + 1, 0, th - 1).long()
    t00 = tex[y0, x0]
    t10 = tex[y0, x1]
    t01 = tex[y1, x0]
    t11 = tex[y1, x1]
    return _lerp2(_lerp2(t00, t10, ax), _lerp2(t01, t11, ax), ay)


def sample(tex, u, v, mode: str):
    if mode == "nearest":
        return sample_nearest(tex, u, v)
    if mode == "bilinear":
        return sample_bilinear(tex, u, v)
    raise ValueError(f"unknown sampling mode: {mode!r}")

"""2D primitives: line, rectangle, circle, transformed bitmap blit.

Port of `dtrenderer_tpu/ops/draw2d.py`. Every op is a full-frame masked
coverage test + premultiplied source-over blend in plain torch ops on the
framebuffer's device. Painter's order = Python call order. These ops write
colour only (no depth).

Positions, sizes, radii and colours are host values (Python numbers or
tuples). Each is rounded to f32 on the host and enters the per-pixel
expressions, which keep the reference's op order, as a scalar operand; a
verb uploads one small tensor per call (its colour, and the constants it
divides by, because a divide by a Python scalar is not an IEEE divide on
every device).

The one deliberate difference from the reference: `cos`/`sin` of a
Transform2D's rotation are taken once on the host (`math.cos`/`math.sin` of
the f32 angle, rounded to f32) and not by the device's `cos`, so the card and
the CPU rotate by identical factors. They may differ from `jnp.cos` in the
last ulp, which moves a mask only at a pixel whose local coordinate lies on
its threshold.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.ops import sampling
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.shading import sqrt_exact
from dtrenderer_tpu_torch.utils.color import blend_over

F32 = torch.float32


class Transform2D(NamedTuple):
    """Mirror of the reference's DTRRenderTransform {rotation, scale, anchor}.

    rotation: radians CCW (screen y-down, so visually clockwise), f32 [];
    scale: f32 [2]; anchor: f32 [2] in [0,1] of the primitive's extent
    (0.5,0.5 = center). The verbs read all three on the host, which
    synchronises when they live on the card.
    """
    rotation: torch.Tensor
    scale: torch.Tensor
    anchor: torch.Tensor


def transform2d(rotation=0.0, scale=1.0, anchor=(0.5, 0.5), *,
                device) -> Transform2D:
    return Transform2D(
        rotation=torch.as_tensor(rotation, dtype=F32, device=device),
        scale=torch.as_tensor(scale, dtype=F32, device=device).expand(2),
        anchor=torch.as_tensor(anchor, dtype=F32, device=device),
    )


def _f32(*xs):
    """Host values rounded to f32 (as np.float32, so host arithmetic on them
    rounds in f32 too)."""
    return [np.float32(x) for x in xs]


def _consts(fb: Framebuffer, *values) -> torch.Tensor:
    """The call's one upload: f32 constants on the framebuffer's device."""
    return torch.tensor([float(v) for v in values], dtype=F32,
                        device=fb.color.device)


def _pixel_grid(fb: Framebuffer):
    """Pixel centres, px [1, W] and py [H, 1] (they broadcast)."""
    h, w = fb.depth.shape
    device = fb.depth.device
    px = (torch.arange(w, dtype=F32, device=device) + 0.5)[None, :]
    py = (torch.arange(h, dtype=F32, device=device) + 0.5)[:, None]
    return px, py


def _composite(fb: Framebuffer, mask, src_rgba) -> Framebuffer:
    """Blend src (premultiplied [4] or [H,W,4]) where mask, color only."""
    blended = blend_over(src_rgba.expand(fb.color.shape), fb.color)
    new_color = torch.where(mask[..., None], blended, fb.color)
    return Framebuffer(color=new_color, depth=fb.depth)


class _HostTransform(NamedTuple):
    cos: float
    sin: float
    scale: tuple
    anchor: tuple


def _read_transform(t: Transform2D) -> _HostTransform:
    """One host read of a Transform2D, and cos/sin of -rotation in f32."""
    rot, sx, sy, ax, ay = _f32(*torch.cat(
        [t.rotation.reshape(1), t.scale, t.anchor]).tolist())
    c, s = _f32(math.cos(-float(rot)), math.sin(-float(rot)))
    return _HostTransform(float(c), float(s), (sx, sy), (ax, ay))


def _inv_transform_coords(px, py, pos, size, ht: _HostTransform, scale):
    """Map framebuffer pixel centers into the primitive's local [0,size] box.

    The primitive of extent `size` is anchored at `pos` by the anchor, scaled
    then rotated about the anchor point. `scale` is the device tensor [2] of
    ht.scale (the divisors).
    """
    dx = px - float(pos[0])
    dy = py - float(pos[1])
    rx = ht.cos * dx - ht.sin * dy
    ry = ht.sin * dx + ht.cos * dy
    lx = rx / scale[0] + float(ht.anchor[0] * size[0])
    ly = ry / scale[1] + float(ht.anchor[1] * size[1])
    return lx, ly


def _inside(lx, ly, size):
    return ((lx >= 0) & (lx < float(size[0])) & (ly >= 0)
            & (ly < float(size[1])))


def fill_rect(fb: Framebuffer, min_xy, max_xy, color,
              t: Transform2D | None = None):
    """DTRRender_Rectangle: [min, max) rect, optionally rotated/scaled about anchor."""
    px, py = _pixel_grid(fb)
    mn = _f32(*min_xy)
    mx = _f32(*max_xy)
    if t is None:
        mask = ((px >= float(mn[0])) & (px < float(mx[0]))
                & (py >= float(mn[1])) & (py < float(mx[1])))
        return _composite(fb, mask, _consts(fb, *color))
    ht = _read_transform(t)
    k = _consts(fb, *color, *ht.scale)
    size = (mx[0] - mn[0], mx[1] - mn[1])
    pos = (mn[0] + ht.anchor[0] * size[0], mn[1] + ht.anchor[1] * size[1])
    lx, ly = _inv_transform_coords(px, py, pos, size, ht, k[4:6])
    return _composite(fb, _inside(lx, ly, size), k[:4])


def line(fb: Framebuffer, p0, p1, color):
    """DTRRender_Line: 1px DDA line (vectorized Bresenham-equivalent coverage).

    A pixel lies on the line iff its major-axis coordinate is in range and its
    minor-axis integer coordinate equals round(DDA(major)).
    """
    p0 = _f32(*p0)
    p1 = _f32(*p1)
    h, w = fb.depth.shape
    device = fb.depth.device
    ix = torch.arange(w, dtype=F32, device=device)[None, :]
    iy = torch.arange(h, dtype=F32, device=device)[:, None]
    dx = p1[0] - p0[0]
    dy = p1[1] - p0[1]

    def axis_mask(maj, mnr, maj0, mnr0, dmaj, dmnr):
        slope = dmnr / (np.float32(1.0) if dmaj == 0 else dmaj)
        expect = torch.floor(
            (float(mnr0) + (maj - float(maj0)) * float(slope)) + 0.5)
        lo = min(maj0, maj0 + dmaj)
        hi = max(maj0, maj0 + dmaj)
        return ((mnr == expect) & (maj >= float(np.floor(lo)))
                & (maj <= float(np.ceil(hi))))

    if abs(dx) >= abs(dy):  # x-major
        mask = axis_mask(ix, iy, np.floor(p0[0]), np.floor(p0[1]), dx, dy)
    else:
        mask = axis_mask(iy, ix, np.floor(p0[1]), np.floor(p0[0]), dy, dx)
    return _composite(fb, mask, _consts(fb, *color))


def _dist2(fb: Framebuffer, center):
    px, py = _pixel_grid(fb)
    cx, cy = _f32(*center)
    ddx = px - float(cx)
    ddy = py - float(cy)
    return ddx * ddx + ddy * ddy


def fill_circle(fb: Framebuffer, center, radius, color):
    r, = _f32(radius)
    mask = _dist2(fb, center) <= float(r * r)
    return _composite(fb, mask, _consts(fb, *color))


def circle_outline(fb: Framebuffer, center, radius, color, thickness=1.0):
    r, th = _f32(radius, thickness)
    d = sqrt_exact(_dist2(fb, center))
    mask = torch.abs(d - float(r)) <= float(th * np.float32(0.5))
    return _composite(fb, mask, _consts(fb, *color))


def blit(
    fb: Framebuffer,
    bitmap,
    pos,
    t: Transform2D | None = None,
    sampling_mode: str = "nearest",
    tint=(1.0, 1.0, 1.0, 1.0),
):
    """DTRRender_Bitmap: blit a premultiplied f32 RGBA bitmap [bh, bw, 4] at pos,
    honoring Transform2D (rotation/scale/anchor) and alpha blending.

    Inverse-maps every framebuffer pixel into bitmap space and samples — rotation
    and scaling come for free, like the reference's transformed blit.
    """
    if t is None:
        ht = _HostTransform(1.0, 0.0, _f32(1.0, 1.0), _f32(0.0, 0.0))
    else:
        ht = _read_transform(t)
    bh, bw = bitmap.shape[0], bitmap.shape[1]
    size = _f32(bw, bh)
    k = _consts(fb, *tint, *ht.scale, *size)
    px, py = _pixel_grid(fb)
    lx, ly = _inv_transform_coords(px, py, _f32(*pos), size, ht, k[4:6])
    inside = _inside(lx, ly, size)

    # Bitmap space: ly is a row from the TOP (screen convention), so v = 1 - ly/bh.
    u = lx / k[6]
    v = 1.0 - ly / k[7]
    texel = sampling.sample(bitmap, u, v, sampling_mode)
    src = texel * k[:4]
    src = torch.where(inside[..., None], src, torch.zeros_like(src))
    return _composite(fb, inside, src)

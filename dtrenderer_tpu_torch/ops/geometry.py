"""Vertex stage: near-plane clipping, viewport, triangle setup.

Port of `dtrenderer_tpu/ops/geometry.py`. All formulas and their op order
follow FORMULAS.md, so coef, bbox and valid equal the reference's bit for bit
(the bbox for every triangle whose bounds lie within +-2^31 pixels; see
triangle_setup_from_corners). Integer bbox arithmetic stays int32, as in the
reference.

Packed setup layout, f32 [T, 16] (the CUDA kernel reads it — keep in sync):
  0:A0 1:B0 2:C0  3:A1 4:B1 5:C1  6:A2 7:B2 8:C2
  9:inv_area2  10:z0 11:z1 12:z2  13:tl0 14:tl1 15:tl2
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dtrenderer_tpu_torch.utils.math3d import (
    homogenize, to_i32, transform_points,
)

F32 = torch.float32
I32 = torch.int32

SETUP_CHANNELS = 16
NEAR_EPS = 1e-4  # rounded to f32 wherever it meets an f32 tensor


class TriSetup(NamedTuple):
    coef: torch.Tensor   # f32 [T, 16] packed per-triangle setup
    bbox: torch.Tensor   # i32 [T, 4]  (x0, y0, x1, y1) inclusive, clamped to frame
    valid: torch.Tensor  # bool [T]


def vertex_transform(verts3, mvp, width, height):
    """[N,3] model-space verts -> [N,4] screen (sx, sy, sz01, q=1/w_clip),
    the viewport mapping of FORMULAS.md (corners_to_screen on the clip
    positions). Vertices with w_clip <= 1e-6 get q=0; triangle_setup drops
    their triangles."""
    return corners_to_screen(
        transform_points(homogenize(verts3.to(F32)), mvp), width, height)


def triangle_setup(screen, faces, width, height, cull_backfaces=True):
    """TriSetup from screen-space verts [N,4] and face indices [T,3]."""
    faces = faces.to(torch.int64)
    return triangle_setup_from_corners(
        screen[faces[:, 0]], screen[faces[:, 1]], screen[faces[:, 2]], width,
        height, cull_backfaces)


def _edge_coef(ax, ay, bx, by):
    """Affine edge coefficients per FORMULAS.md: E(p) = (A*px + B*py) + C."""
    A = by - ay
    B = ax - bx
    C = -(ax * A + ay * B)
    return A, B, C


def _top_left(ax, ay, bx, by):
    """Top-left fill-rule flag for directed edge a->b (FORMULAS.md)."""
    return ((ay == by) & (bx < ax)) | (by < ay)


def bbox_steps(width, height, device):
    """The bbox's constants, i32 [2, 4]: the 1px slack added to (x0, y0, x1,
    y1) and the frame's last column and row that clamp them."""
    return torch.tensor([[-1, -1, 1, 1],
                         [width - 1, height - 1, width - 1, height - 1]],
                        dtype=I32, device=device)


def triangle_setup_from_corners(p0, p1, p2, width, height, cull_backfaces=True):
    """Triangle setup from corner arrays [T,4] (sx, sy, sz, q)."""
    return setup_with_steps(p0, p1, p2, width, height, cull_backfaces,
                            bbox_steps(width, height, p0.device))


def setup_with_steps(p0, p1, p2, width, height, cull_backfaces, step_and_hi):
    """triangle_setup_from_corners with its bbox constants (bbox_steps) made
    by the caller: no host-to-device copy, so a CUDA graph can capture it."""
    x0, y0, z0 = p0[:, 0], p0[:, 1], p0[:, 2]
    x1, y1, z1 = p1[:, 0], p1[:, 1], p1[:, 2]
    x2, y2, z2 = p2[:, 0], p2[:, 1], p2[:, 2]

    # Edge opposite v0 is v1->v2, opposite v1 is v2->v0, opposite v2 is v0->v1.
    A0, B0, C0 = _edge_coef(x1, y1, x2, y2)
    A1, B1, C1 = _edge_coef(x2, y2, x0, y0)
    A2, B2, C2 = _edge_coef(x0, y0, x1, y1)
    area2 = (A2 * x2 + B2 * y2) + C2

    any_behind = (p0[:, 3] == 0) | (p1[:, 3] == 0) | (p2[:, 3] == 0)
    finite = (
        torch.isfinite(x0) & torch.isfinite(y0)
        & torch.isfinite(x1) & torch.isfinite(y1)
        & torch.isfinite(x2) & torch.isfinite(y2)
    )
    if cull_backfaces:
        valid = finite & ~any_behind & (area2 > 0)
        flip = torch.zeros_like(valid)
    else:
        valid = finite & ~any_behind & (area2 != 0)
        flip = area2 < 0

    one = torch.ones_like(area2)
    sgn = torch.where(flip, -one, one)
    A0, B0, C0 = A0 * sgn, B0 * sgn, C0 * sgn
    A1, B1, C1 = A1 * sgn, B1 * sgn, C1 * sgn
    A2, B2, C2 = A2 * sgn, B2 * sgn, C2 * sgn
    area2 = area2 * sgn
    inv_area2 = torch.reciprocal(torch.where(valid, area2, one))

    # Fill-rule flags use the EFFECTIVE directed edge: flipping the winding
    # reverses each edge's direction (FORMULAS.md "Inside test").
    def tl(ax, ay, bx, by):
        fwd = _top_left(ax, ay, bx, by)
        rev = _top_left(bx, by, ax, ay)
        return torch.where(flip, rev, fwd).to(F32)

    coef = torch.stack(
        [A0, B0, C0, A1, B1, C1, A2, B2, C2, inv_area2, z0, z1, z2,
         tl(x1, y1, x2, y2), tl(x2, y2, x0, y0), tl(x0, y0, x1, y1)],
        dim=-1,
    )

    # Conservative pixel bbox (1px slack; the inside test is the arbiter).
    zero = torch.zeros_like(x0)
    safe_xs = torch.where(valid[:, None], torch.stack([x0, x1, x2], -1),
                          zero[:, None])
    safe_ys = torch.where(valid[:, None], torch.stack([y0, y1, y2], -1),
                          zero[:, None])
    xmin, xmax = safe_xs.amin(-1), safe_xs.amax(-1)
    ymin, ymax = safe_ys.amin(-1), safe_ys.amax(-1)
    # Clamped in float before the one conversion, so that a bound beyond
    # +-2^31 pixels cannot saturate and wrap at the +-1: the bbox then holds
    # every pixel the triangle covers, and every route draws what the
    # unbinned "ref" route draws. The reference converts first; its bbox of
    # such a triangle misses pixels, and its binned routes draw what their
    # tile size lets through. In range the two bboxes are equal.
    edges = torch.stack([torch.floor(xmin), torch.floor(ymin),
                         torch.ceil(xmax), torch.ceil(ymax)], dim=-1)
    edges = to_i32(torch.clamp(edges, -1.0, float(max(width, height))))
    bbox = torch.minimum((edges + step_and_hi[0]).clamp_min(0), step_and_hi[1])
    # Off-screen triangles collapse to an empty bbox.
    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    valid = valid & ~offscreen
    return TriSetup(coef=coef, bbox=bbox, valid=valid)


def coverage_and_depth(coef, px, py):
    """Coverage + interpolated depth + barycentrics at pixel centers.

    coef: f32 [..., 16] broadcastable against px/py. Returns (inside bool,
    z f32, (b0, b1, b2)). Op order per FORMULAS.md."""
    A0, B0, C0 = coef[..., 0], coef[..., 1], coef[..., 2]
    A1, B1, C1 = coef[..., 3], coef[..., 4], coef[..., 5]
    A2, B2, C2 = coef[..., 6], coef[..., 7], coef[..., 8]
    inv_area2 = coef[..., 9]
    z0, z1, z2 = coef[..., 10], coef[..., 11], coef[..., 12]
    tl0, tl1, tl2 = coef[..., 13], coef[..., 14], coef[..., 15]

    E0 = (A0 * px + B0 * py) + C0
    E1 = (A1 * px + B1 * py) + C1
    E2 = (A2 * px + B2 * py) + C2

    acc0 = (E0 > 0) | ((E0 == 0) & (tl0 > 0))
    acc1 = (E1 > 0) | ((E1 == 0) & (tl1 > 0))
    acc2 = (E2 > 0) | ((E2 == 0) & (tl2 > 0))
    inside = acc0 & acc1 & acc2

    b0 = E0 * inv_area2
    b1 = E1 * inv_area2
    b2 = E2 * inv_area2
    z = (b0 * z0 + b1 * z1) + b2 * z2
    return inside, z, (b0, b1, b2)


def interp(b, a0, a1, a2):
    """Barycentric interpolation with fixed op order (FORMULAS.md)."""
    b0, b1, b2 = b
    return (b0 * a0 + b1 * a1) + b2 * a2


def clip_near(corners_clip, corner_attrs, eps=NEAR_EPS):
    """Clip triangles against the near plane w = eps in clip space.

    corners_clip: f32 [T, 3, 4]; corner_attrs: f32 [T, 3, A] raw (not
    q-premultiplied) attributes. Returns (clip2 [T, 2, 3, 4],
    attrs2 [T, 2, 3, A], valid2 [T, 2]): each triangle maps to up to two
    (a triangle with two corners in front clips to a quad). Triangles fully in
    front pass through bit-identical in slot 0.
    """
    inside = corners_clip[..., 3] >= eps
    cnt = inside.to(I32).sum(dim=1)

    # Canonical rotations: cnt==1 -> the single INSIDE vertex becomes corner 0;
    # cnt==2 -> the single OUTSIDE vertex becomes corner 2.
    in_idx = torch.argmax(inside.to(I32), dim=1)
    out_idx = torch.argmax((~inside).to(I32), dim=1)
    start = torch.where(cnt == 1, in_idx,
                        torch.where(cnt == 2, (out_idx + 1) % 3,
                                    torch.zeros_like(in_idx)))
    idx = (start[:, None] + torch.arange(3, device=start.device)[None, :]) % 3
    c = torch.gather(corners_clip, 1,
                     idx[..., None].expand(-1, -1, corners_clip.shape[-1]))
    a = torch.gather(corner_attrs, 1,
                     idx[..., None].expand(-1, -1, corner_attrs.shape[-1]))
    w = c[..., 3]

    def isect(i, j):
        """Intersection of edge corner_i -> corner_j with the w = eps plane."""
        wi = w[:, i:i + 1]
        denom = w[:, j:j + 1] - wi
        t = (eps - wi) / torch.where(denom == 0, torch.ones_like(denom), denom)
        t = torch.clamp(t, 0.0, 1.0)
        ci, cj = c[:, i], c[:, j]
        ai, aj = a[:, i], a[:, j]
        return ci + (cj - ci) * t, ai + (aj - ai) * t

    # cnt == 1 (A=corner0 inside): A, AB_x, AC_x
    ab_c, ab_a = isect(0, 1)
    ac_c, ac_a = isect(0, 2)
    tri1_c = torch.stack([c[:, 0], ab_c, ac_c], dim=1)
    tri1_a = torch.stack([a[:, 0], ab_a, ac_a], dim=1)

    # cnt == 2 (A,B inside, C=corner2 outside): (A, B, BC_x) and (A, BC_x, AC_x)
    bc_c, bc_a = isect(1, 2)
    tri2a_c = torch.stack([c[:, 0], c[:, 1], bc_c], dim=1)
    tri2a_a = torch.stack([a[:, 0], a[:, 1], bc_a], dim=1)
    tri2b_c = torch.stack([c[:, 0], bc_c, ac_c], dim=1)
    tri2b_a = torch.stack([a[:, 0], bc_a, ac_a], dim=1)

    cnt_b = cnt[:, None, None]
    slot0_c = torch.where(cnt_b == 2, tri2a_c, torch.where(cnt_b == 1, tri1_c, c))
    slot0_a = torch.where(cnt_b == 2, tri2a_a, torch.where(cnt_b == 1, tri1_a, a))
    clip2 = torch.stack([slot0_c, tri2b_c], dim=1)
    attrs2 = torch.stack([slot0_a, tri2b_a], dim=1)
    valid2 = torch.stack([cnt >= 1, cnt == 2], dim=1)
    return clip2, attrs2, valid2


def corners_to_screen(corners_clip, width, height):
    """Per-corner clip -> screen (sx, sy, sz01, q), FORMULAS.md viewport."""
    w = corners_clip[..., 3]
    behind = w <= 1e-6
    one = torch.ones_like(w)
    q = torch.where(behind, torch.zeros_like(w),
                    torch.reciprocal(torch.where(behind, one, w)))
    x_ndc = corners_clip[..., 0] * q
    y_ndc = corners_clip[..., 1] * q
    z_ndc = corners_clip[..., 2] * q
    sx = (x_ndc + 1.0) * (0.5 * width)
    sy = (1.0 - y_ndc) * (0.5 * height)
    sz = (z_ndc + 1.0) * 0.5
    return torch.stack([sx, sy, sz, q], dim=-1)

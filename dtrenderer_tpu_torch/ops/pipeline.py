"""The 3D draw-call pipeline: vertex stage -> binning -> fused raster+shade
kernel -> depth merge and blend.

Port of the opaque fused path of `dtrenderer_tpu/ops/pipeline.py`
(`draw_mesh(backend="fused")` and the batched `draw_meshes`). A draw is eager
torch for the vertex stage and the binning, then one kernel launch
(ops/render_fused.py), then the merge `win = z < fb.depth; color =
where(win, blend_over(src, color), color)`.

Not served yet, and raising NotImplementedError rather than rerouting:
translucent draws in `draw_meshes` (they need `draw_mesh_ordered`, the
ordered kernel of ops/raster_ordered.py), `backend="ref"` (ops/raster_ref.py)
and `backend="pallas"` (ops/raster_pallas.py), and any `raster_opts` key
(the reference's TPU binning and kernel knobs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.debug import FrameCounters
from dtrenderer_tpu_torch.models.primitives import white_texture
from dtrenderer_tpu_torch.ops import geometry
from dtrenderer_tpu_torch.ops.binning import bin_triangles
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.render_fused import (
    TILE_H, TILE_W, make_texture_lut, pack_flags, pack_payload, render_fused,
)
from dtrenderer_tpu_torch.ops.shading import (
    SHADING_FLAT, SHADING_GOURAUD, SHADING_NONE, SHADING_PHONG, Light,
    apply_light, light_term, make_light,
)
from dtrenderer_tpu_torch.utils.color import blend_over
from dtrenderer_tpu_torch.utils.math3d import (
    homogenize, mat4mul, transform_directions, transform_points,
)

F32 = torch.float32
SAMPLING_MODES = ("nearest", "bilinear")


def _cross(a, b):
    """Cross product in the reference's op order (a1*b2 - a2*b1, ...)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def gather_corner_data(mesh, model, mvp, normal_mat, light: Light, color,
                       shading: str):
    """Per-corner clip positions [T,3,4] + raw (NOT q-premultiplied) attributes
    [T, 3, 9]: u, v, r, g, b, a (lit per mode), nx, ny, nz — linear in world
    space, so they clip-lerp exactly (geometry.clip_near). Per-vertex work
    (clip transform, Gouraud lighting) runs before one [T, 3, D] gather."""
    faces = mesh.faces
    device = mesh.verts.device
    color = torch.as_tensor(color, dtype=F32, device=device)
    clip4 = transform_points(homogenize(mesh.verts), mvp)  # [N, 4]
    N = clip4.shape[0]

    cols = [clip4, mesh.uv]  # 4 + 2
    if shading == SHADING_FLAT:
        cols.append(transform_points(homogenize(mesh.verts), model)[..., :3])
    elif shading == SHADING_GOURAUD:
        vterm = light_term(transform_directions(mesh.normals, normal_mat),
                           light)
        cols.append(apply_light(color.expand(N, 4), vterm))
    elif shading == SHADING_PHONG:
        cols.append(transform_directions(mesh.normals, normal_mat))
    elif shading != SHADING_NONE:
        raise ValueError(f"unknown shading mode {shading!r}")

    g = torch.cat(cols, dim=-1)[faces]  # [T, 3, D]
    corners_clip = g[..., 0:4]
    uv = g[..., 4:6]

    T = faces.shape[0]
    zeros3 = torch.zeros((T, 3, 3), dtype=F32, device=device)
    if shading == SHADING_FLAT:
        w0, w1, w2 = g[:, 0, 6:9], g[:, 1, 6:9], g[:, 2, 6:9]
        term = light_term(_cross(w1 - w0, w2 - w0), light)
        corner_rgba = apply_light(color.expand(T, 3, 4), term[:, None])
        nq = zeros3
    elif shading == SHADING_GOURAUD:
        corner_rgba = g[..., 6:10]
        nq = zeros3
    elif shading == SHADING_PHONG:
        corner_rgba = color.expand(T, 3, 4)
        nq = g[..., 6:9]
    else:  # SHADING_NONE
        corner_rgba = color.expand(T, 3, 4)
        nq = zeros3
    return corners_clip, torch.cat([uv, corner_rgba, nq], dim=-1)


def corner_attrs_with_q(screen_corners, raw):
    """[T,3,10] q-premultiplied channels (q, u*q, v*q, rgba*q, n*q)."""
    q = screen_corners[..., 3:4]
    return torch.cat(
        [q, raw[..., 0:2] * q, raw[..., 2:6] * q, raw[..., 6:9] * q], dim=-1
    )


def prepare_draw(mesh, model, view_proj, mvp, normal_mat, light, color,
                 shading, frame_w, frame_h, cull_backfaces=True,
                 near_clip=True):
    """Geometry stage: transform, optional near-plane clip, viewport,
    triangle setup, q-premultiplied corner attrs. Returns (TriSetup,
    attrs10 [T',3,10]), T' = 2T when clipping."""
    corners_clip, raw = gather_corner_data(
        mesh, model, mvp, normal_mat, light, color, shading)

    pre_valid = None
    if near_clip:
        clip2, attrs2, valid2 = geometry.clip_near(corners_clip, raw)
        Tp = corners_clip.shape[0] * 2
        corners_clip = clip2.reshape(Tp, 3, 4)
        raw = attrs2.reshape(Tp, 3, 9)
        pre_valid = valid2.reshape(Tp)

    screen_c = geometry.corners_to_screen(corners_clip, frame_w, frame_h)
    setup = geometry.triangle_setup_from_corners(
        screen_c[:, 0], screen_c[:, 1], screen_c[:, 2],
        frame_w, frame_h, cull_backfaces,
    )
    if pre_valid is not None:
        setup = setup._replace(valid=setup.valid & pre_valid)
    return setup, corner_attrs_with_q(screen_c, raw)


class DrawSpec:
    """One mesh submission for the batched scene path (draw_meshes).

    sampling: per-draw texture sampling mode ("nearest"/"bilinear"); None
    inherits draw_meshes' scene-wide sampling_mode. translucent: None =
    auto-detect from color alpha (is_translucent_draw)."""

    def __init__(self, mesh, model, texture=None, color=(1.0, 1.0, 1.0, 1.0),
                 shading: str = SHADING_GOURAUD, normal_mat=None,
                 sampling: str | None = None, translucent: bool | None = None):
        if sampling not in (None, *SAMPLING_MODES):
            raise ValueError(f"unknown sampling mode {sampling!r}")
        self.mesh = mesh
        self.model = model
        self.texture = texture
        self.color = color
        self.shading = shading
        self.normal_mat = normal_mat
        self.sampling = sampling
        self.translucent = translucent


def is_translucent_draw(d: DrawSpec) -> bool:
    """Explicit d.translucent wins; otherwise a draw is translucent when its
    host-known color alpha is < 1."""
    if d.translucent is not None:
        return bool(d.translucent)
    c = d.color.detach().cpu() if torch.is_tensor(d.color) else d.color
    return float(np.asarray(c, np.float32).reshape(-1)[3]) < 1.0


def _check_unported(backend: str, raster_opts):
    if backend == "ref":
        raise NotImplementedError(
            "backend='ref' needs ops/raster_ref.py and shade_deferred, not "
            "ported yet; the port serves backend='fused'")
    if backend == "pallas":
        raise NotImplementedError(
            "backend='pallas' needs ops/raster_pallas.py (the visibility "
            "kernel), not ported yet; the port serves backend='fused'")
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r}")
    if raster_opts:
        raise NotImplementedError(
            f"raster_opts {sorted(raster_opts)} are the reference's TPU "
            f"binning/kernel knobs; the port's kernel takes none")


class DrawBatch(NamedTuple):
    """Everything one kernel launch needs, for a list of draws."""
    coef: torch.Tensor     # f32 [T, 16]
    bbox: torch.Tensor     # i32 [T, 4]
    valid: torch.Tensor    # bool [T]
    payload: torch.Tensor  # f32 [T, 34]
    tex_lut: torch.Tensor  # f32 [L, 4]


def pack_draws(draws, view_proj, light: Light, sampling_mode: str,
               frame_w: int, frame_h: int, cull_backfaces: bool = True,
               near_clip: bool = True, mvps=None) -> DrawBatch:
    """Vertex stage and packing for a list of opaque DrawSpecs: per draw,
    prepare_draw and pack_payload; then one concatenated coef/bbox/valid/
    payload and one texture LUT. mvps optionally overrides each draw's
    view_proj @ model."""
    if sampling_mode not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {sampling_mode!r}")
    device = light.direction.device
    white = white_texture(device=device)
    tex_lut, meta = make_texture_lut(
        [d.texture if d.texture is not None else white for d in draws])
    coefs, bboxes, valids, payloads = [], [], [], []
    for i, (d, m) in enumerate(zip(draws, meta)):
        normal_mat = d.normal_mat if d.normal_mat is not None else d.model
        mvp = mvps[i] if mvps is not None else mat4mul(view_proj, d.model)
        setup, attrs10 = prepare_draw(
            d.mesh, d.model, view_proj, mvp, normal_mat, light, d.color,
            d.shading, frame_w, frame_h, cull_backfaces, near_clip,
        )
        flags = pack_flags(d.shading == SHADING_PHONG,
                           (d.sampling or sampling_mode) == "bilinear")
        payloads.append(pack_payload(attrs10, m, flags))
        coefs.append(setup.coef)
        bboxes.append(setup.bbox)
        valids.append(setup.valid)
    return DrawBatch(torch.cat(coefs), torch.cat(bboxes), torch.cat(valids),
                     torch.cat(payloads), tex_lut)


def _render_and_merge(fb: Framebuffer, batch: DrawBatch, light: Light,
                      y_offset: int, x_offset: int, return_counters: bool):
    """Bin, launch the fused kernel once, and merge into the framebuffer."""
    h, w = fb.depth.shape
    bins = bin_triangles(batch.coef, batch.bbox, batch.valid, h, w, y_offset,
                         x_offset, TILE_H, TILE_W)
    z, src, overflow = render_fused(batch.coef, batch.payload, bins,
                                    batch.tex_lut, light, h, w, y_offset,
                                    x_offset)
    win = z < fb.depth
    out = Framebuffer(
        color=torch.where(win[..., None], blend_over(src, fb.color), fb.color),
        depth=torch.where(win, z, fb.depth),
    )
    if not return_counters:
        return out
    return out, FrameCounters(
        tris_submitted=torch.tensor(batch.coef.shape[0], dtype=torch.int32,
                                    device=batch.coef.device),
        tris_valid=batch.valid.sum(dtype=torch.int32),
        pixels_shaded=win.sum(dtype=torch.int32),
        bin_overflow=overflow,
    )


def draw_mesh(
    fb: Framebuffer,
    mesh,
    model,
    view_proj,
    texture=None,
    light: Light | None = None,
    color=(1.0, 1.0, 1.0, 1.0),
    shading: str = SHADING_GOURAUD,
    sampling_mode: str = "nearest",
    cull_backfaces: bool = True,
    normal_mat=None,
    backend: str = "ref",
    mvp=None,
    frame_height=None,
    frame_width=None,
    y_offset: int = 0,
    x_offset: int = 0,
    raster_opts: dict | None = None,
    return_counters: bool = False,
    near_clip: bool = True,
):
    """Render one mesh draw call into the framebuffer (DTRRender_Mesh analog).

    Same signature and default as the reference; only backend="fused" is
    ported. When fb is a band/tile of a larger frame, pass the full frame dims
    (frame_height/frame_width) and this shard's origin (y_offset/x_offset).
    """
    _check_unported(backend, raster_opts)
    h, w = fb.depth.shape
    if light is None:
        light = make_light(device=fb.depth.device)
    spec = DrawSpec(mesh, model, texture=texture, color=color,
                    shading=shading, normal_mat=normal_mat)
    batch = pack_draws(
        [spec], view_proj, light, sampling_mode,
        frame_width if frame_width is not None else w,
        frame_height if frame_height is not None else h,
        cull_backfaces, near_clip, mvps=None if mvp is None else [mvp])
    return _render_and_merge(fb, batch, light, y_offset, x_offset,
                             return_counters)


def draw_meshes(
    fb: Framebuffer,
    view_proj,
    draws,
    light: Light | None = None,
    sampling_mode: str = "bilinear",
    cull_backfaces: bool = True,
    frame_height=None,
    frame_width=None,
    y_offset: int = 0,
    x_offset: int = 0,
    raster_opts: dict | None = None,
    near_clip: bool = True,
    return_counters: bool = False,
):
    """Batched opaque scene submission: all draws rasterize and shade in ONE
    kernel launch, each with its own texture (one LUT, per-triangle base
    offsets), shading mode, color and sampling mode (DrawSpec.sampling
    overrides `sampling_mode`). Exactly equivalent to sequential draws for
    opaque geometry: the (min z, min id) winner is order-free and the blend
    happens once against the pre-scene framebuffer (FORMULAS.md).
    """
    _check_unported("fused", raster_opts)
    if any(is_translucent_draw(d) for d in draws):
        raise NotImplementedError(
            "translucent draws need draw_mesh_ordered (ops/raster_ordered.py, "
            "the ordered kernel) and the opaque/translucent partition of "
            "draw_meshes, not ported yet")
    h, w = fb.depth.shape
    if light is None:
        light = make_light(device=fb.depth.device)
    batch = pack_draws(
        draws, view_proj, light, sampling_mode,
        frame_width if frame_width is not None else w,
        frame_height if frame_height is not None else h,
        cull_backfaces, near_clip)
    return _render_and_merge(fb, batch, light, y_offset, x_offset,
                             return_counters)

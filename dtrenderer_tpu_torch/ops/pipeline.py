"""The 3D draw-call pipeline: vertex stage -> binning -> raster kernels ->
depth merge and blend.

Port of `dtrenderer_tpu/ops/pipeline.py`. A draw is eager torch for the
vertex stage and the binning, then one kernel launch, then the merge:

- `draw_mesh(backend="fused")` and the opaque runs of `draw_meshes`: the
  fused raster+shade kernel (ops/render_fused.py), merged with
  `win = z < fb.depth; color = where(win, blend_over(src, color), color)`;
- `draw_mesh(backend="pallas")`: the visibility kernel
  (ops/raster_pallas.py), then `shade_deferred`;
- `draw_mesh(backend="ref")`: the plain-torch full-frame raster
  (ops/raster_ref.py), then `shade_deferred`;
- `draw_mesh_ordered` and the translucent draws of `draw_meshes`: the
  ordered kernel (ops/raster_ordered.py, engine "tile"), or the reference's
  per-triangle loop (engine "scan").

Any `raster_opts` or `ordered_opts` key raises NotImplementedError: they are
the reference's TPU binning and kernel knobs, and the port's kernels take
none.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.debug import FrameCounters
from dtrenderer_tpu_torch.models.primitives import white_texture
from dtrenderer_tpu_torch.ops import geometry, sampling
from dtrenderer_tpu_torch.ops.binning import bin_triangles
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.raster_ordered import render_ordered
from dtrenderer_tpu_torch.ops.raster_pallas import rasterize_pallas
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
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


BACKENDS = ("ref", "pallas", "fused")
ORDERED_ENGINES = ("tile", "scan")


def _check_opts(name: str, opts):
    if opts:
        raise NotImplementedError(
            f"{name} {sorted(opts)} are the reference's TPU binning/kernel "
            f"knobs; the port's kernels take none")


def _check_sampling(sampling_mode: str):
    if sampling_mode not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {sampling_mode!r}")


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
    """Vertex stage and packing for a list of DrawSpecs: per draw,
    prepare_draw and pack_payload; then one concatenated coef/bbox/valid/
    payload and one texture LUT. mvps optionally overrides each draw's
    view_proj @ model."""
    _check_sampling(sampling_mode)
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


def _shade_fragments(ip, texture, sampling_mode: str, shading: str,
                     light: Light):
    """Shade interpolated q-premultiplied attrs ip [..., 10] -> premultiplied
    src [..., 4]: perspective divide, texture sample, modulate, optional
    per-pixel Phong (FORMULAS.md; the reference's shade_deferred)."""
    qf = ip[..., 0]
    inv_qf = torch.reciprocal(torch.where(qf != 0, qf, torch.ones_like(qf)))
    u = ip[..., 1] * inv_qf
    v = ip[..., 2] * inv_qf
    rgba = ip[..., 3:7] * inv_qf[..., None]
    src = sampling.sample(texture, u, v, sampling_mode) * rgba
    if shading == SHADING_PHONG:
        n = ip[..., 7:10] * inv_qf[..., None]
        src = apply_light(src, light_term(n, light))
    return src


def shade_deferred(fb: Framebuffer, z, tri, coef, attrs, texture,
                   sampling_mode: str, shading_mode: str, light: Light,
                   y_offset: int = 0, x_offset: int = 0) -> Framebuffer:
    """Deferred pass: shade the winning fragments of a visibility G-buffer
    (z, tri) and merge them into the framebuffer. attrs: q-premultiplied
    corner attrs [T, 3, 10]. Only the pixels that win the depth test are
    gathered and shaded (the reference gathers the whole frame); the values
    are the same."""
    win = (tri >= 0) & (z < fb.depth)
    color = fb.color.clone()
    ys, xs = win.nonzero(as_tuple=True)
    if ys.numel():
        t = tri[ys, xs].to(torch.int64)
        px = (xs + x_offset).to(F32) + 0.5
        py = (ys + y_offset).to(F32) + 0.5
        _, _, b = geometry.coverage_and_depth(coef[t], px, py)
        a = attrs[t]
        ip = geometry.interp(tuple(bb[:, None] for bb in b), a[:, 0], a[:, 1],
                             a[:, 2])
        src = _shade_fragments(ip, texture, sampling_mode, shading_mode,
                               light)
        color[ys, xs] = blend_over(src, fb.color[ys, xs])
    return Framebuffer(color=color, depth=torch.where(win, z, fb.depth))


def _finish_draw(out, fb, mesh, setup, z, tri, overflow, return_counters):
    if not return_counters:
        return out
    return out, FrameCounters(
        tris_submitted=torch.tensor(mesh.faces.shape[0], dtype=torch.int32,
                                    device=z.device),
        tris_valid=setup.valid.sum(dtype=torch.int32),
        pixels_shaded=((tri >= 0) & (z < fb.depth)).sum(dtype=torch.int32),
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

    Same signature and default as the reference. backend: "fused" (one
    raster+shade kernel launch), "pallas" (the visibility kernel, then
    shade_deferred) or "ref" (plain-torch full-frame raster, then
    shade_deferred); all three give the same image. When fb is a band/tile
    of a larger frame, pass the full frame dims (frame_height/frame_width)
    and this shard's origin (y_offset/x_offset).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    _check_opts("raster_opts", raster_opts)
    _check_sampling(sampling_mode)
    h, w = fb.depth.shape
    fh = frame_height if frame_height is not None else h
    fw = frame_width if frame_width is not None else w
    if light is None:
        light = make_light(device=fb.depth.device)
    if backend == "fused":
        spec = DrawSpec(mesh, model, texture=texture, color=color,
                        shading=shading, normal_mat=normal_mat)
        batch = pack_draws([spec], view_proj, light, sampling_mode, fw, fh,
                           cull_backfaces, near_clip,
                           mvps=None if mvp is None else [mvp])
        return _render_and_merge(fb, batch, light, y_offset, x_offset,
                                 return_counters)

    if mvp is None:
        mvp = mat4mul(view_proj, model)
    setup, attrs10 = prepare_draw(
        mesh, model, view_proj, mvp,
        normal_mat if normal_mat is not None else model, light, color,
        shading, fw, fh, cull_backfaces, near_clip)
    if backend == "ref":
        z, tri = rasterize_ref(setup.coef, setup.valid, h, w,
                               y_offset=y_offset, x_offset=x_offset)
        overflow = torch.zeros((), dtype=torch.int32, device=z.device)
    else:
        z, tri, overflow = rasterize_pallas(setup.coef, setup.bbox,
                                            setup.valid, h, w, y_offset,
                                            x_offset)
    if texture is None:
        texture = white_texture(device=fb.depth.device)
    out = shade_deferred(fb, z, tri, setup.coef, attrs10, texture,
                         sampling_mode, shading, light, y_offset, x_offset)
    return _finish_draw(out, fb, mesh, setup, z, tri, overflow,
                        return_counters)


def draw_mesh_ordered(
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
    mvp=None,
    frame_height=None,
    frame_width=None,
    y_offset: int = 0,
    x_offset: int = 0,
    near_clip: bool = True,
    window: tuple[int, int] | None = (64, 128),
    engine: str = "auto",
    raster_opts: dict | None = None,
    return_counters: bool = False,
):
    """Submission-order draw: per triangle, in submission order, the
    z-test against the running depth, a source-over blend and a depth
    write: the reference renderer's forward loop, which the order-free
    fused path cannot reproduce for translucent geometry.

    engine:
      "tile" -- the ordered kernel (ops/raster_ordered.py): each 16x16
                tile walks its binned triangles in id (= submission) order.
      "scan" -- the reference's per-triangle loop in plain torch: each step
                evaluates a `window` (wh, ww) placed over the triangle's
                bbox (the whole frame for larger triangles; window=None
                always takes the whole frame). Bit-equal at any window
                size, and to "tile". Runs only when a caller names it.
      "auto" -- "tile" (the port has no texture-size limit to route on).

    return_counters: also return FrameCounters (bin_overflow always 0).
    """
    if engine == "auto":
        engine = "tile"
    if engine not in ORDERED_ENGINES:
        raise ValueError(f"unknown ordered engine {engine!r}")
    _check_opts("raster_opts", raster_opts)
    _check_sampling(sampling_mode)
    h, w = fb.depth.shape
    fh = frame_height if frame_height is not None else h
    fw = frame_width if frame_width is not None else w
    if light is None:
        light = make_light(device=fb.depth.device)

    if engine == "tile":
        spec = DrawSpec(mesh, model, texture=texture, color=color,
                        shading=shading, normal_mat=normal_mat)
        batch = pack_draws([spec], view_proj, light, sampling_mode, fw, fh,
                           cull_backfaces, near_clip,
                           mvps=None if mvp is None else [mvp])
        color_o, depth_o, overflow = render_ordered(
            batch.coef, batch.bbox, batch.valid, batch.payload, batch.tex_lut,
            light, fb.color, fb.depth, h, w, y_offset, x_offset)
        n_rows, valid = batch.coef.shape[0], batch.valid
    else:
        if mvp is None:
            mvp = mat4mul(view_proj, model)
        setup, attrs10 = prepare_draw(
            mesh, model, view_proj, mvp,
            normal_mat if normal_mat is not None else model, light, color,
            shading, fw, fh, cull_backfaces, near_clip)
        if texture is None:
            texture = white_texture(device=fb.depth.device)
        color_o, depth_o = _draw_scan(fb, setup, attrs10, texture,
                                      sampling_mode, shading, light, window,
                                      y_offset, x_offset)
        overflow = torch.zeros((), dtype=torch.int32, device=fb.depth.device)
        n_rows, valid = setup.coef.shape[0], setup.valid
    out = Framebuffer(color=color_o, depth=depth_o)
    if not return_counters:
        return out
    return out, FrameCounters(
        tris_submitted=torch.tensor(n_rows, dtype=torch.int32,
                                    device=depth_o.device),
        tris_valid=valid.sum(dtype=torch.int32),
        pixels_shaded=(depth_o < fb.depth).sum(dtype=torch.int32),
        bin_overflow=overflow,
    )


def _draw_scan(fb: Framebuffer, setup, attrs, texture, sampling_mode: str,
               shading: str, light: Light, window, y_offset: int,
               x_offset: int):
    """draw_mesh_ordered's "scan" engine: one step per setup row, in order.
    A step evaluates the triangle over a window (or the whole frame), so the
    pixel centres' values, not the patch's shape, decide the result."""
    h, w = fb.depth.shape
    device = fb.depth.device
    wh, ww = (h, w) if window is None else (min(window[0], h),
                                            min(window[1], w))
    color = fb.color.clone()
    depth = fb.depth.clone()
    ys = (torch.arange(h, device=device) + y_offset).to(F32) + 0.5
    xs = (torch.arange(w, device=device) + x_offset).to(F32) + 0.5
    for t, ((bx0, by0, bx1, by1), valid) in enumerate(
            zip(setup.bbox.tolist(), setup.valid.tolist())):
        # bbox is in frame coordinates; this fb may be a band (offsets)
        if not (valid and bx1 >= x_offset and bx0 < x_offset + w
                and by1 >= y_offset and by0 < y_offset + h):
            continue
        lx0 = min(max(bx0 - x_offset, 0), w - 1)
        ly0 = min(max(by0 - y_offset, 0), h - 1)
        lx1 = min(max(bx1 - x_offset, 0), w - 1)
        ly1 = min(max(by1 - y_offset, 0), h - 1)
        if lx1 - lx0 + 1 <= ww and ly1 - ly0 + 1 <= wh:
            oy, ox, ph, pw = min(ly0, h - wh), min(lx0, w - ww), wh, ww
        else:
            oy, ox, ph, pw = 0, 0, h, w
        win_y, win_x = slice(oy, oy + ph), slice(ox, ox + pw)
        inside, z, b = geometry.coverage_and_depth(
            setup.coef[t], xs[win_x][None, :], ys[win_y][:, None])
        a = attrs[t]
        ip = geometry.interp(tuple(bb[..., None] for bb in b), a[0], a[1],
                             a[2])
        src = _shade_fragments(ip, texture, sampling_mode, shading, light)
        c_p, d_p = color[win_y, win_x], depth[win_y, win_x]
        hit = inside & (z < d_p)
        color[win_y, win_x] = torch.where(hit[..., None],
                                          blend_over(src, c_p), c_p)
        depth[win_y, win_x] = torch.where(hit, z, d_p)
    return color, depth


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
    ordered_opts: dict | None = None,
    ordered_engine: str = "auto",
):
    """Batched scene submission, in submission order: the draws are cut
    into maximal runs of opaque draws and single translucent draws
    (is_translucent_draw). Each opaque run rasterizes and shades in ONE
    fused kernel launch, each draw with its own texture (one LUT,
    per-triangle base offsets), shading mode, colour and sampling mode
    (DrawSpec.sampling overrides `sampling_mode`); within a run this is
    exactly sequential draws, because the (min z, min id) winner is
    order-free and the blend happens once against the framebuffer before
    the run (FORMULAS.md). Each translucent draw goes through
    draw_mesh_ordered (engine `ordered_engine`), blending over everything
    before it and writing depth. Counters of all segments are merged.
    """
    _check_opts("raster_opts", raster_opts)
    _check_opts("ordered_opts", ordered_opts)
    _check_sampling(sampling_mode)
    h, w = fb.depth.shape
    fh = frame_height if frame_height is not None else h
    fw = frame_width if frame_width is not None else w
    if light is None:
        light = make_light(device=fb.depth.device)

    segments: list[tuple[bool, list]] = []  # (translucent, draws)
    for d in draws:
        translucent = is_translucent_draw(d)
        if not translucent and segments and not segments[-1][0]:
            segments[-1][1].append(d)
        else:
            segments.append((translucent, [d]))

    out = fb
    counters = FrameCounters.zero(fb.depth.device)
    for translucent, seg in segments:
        if translucent:
            d = seg[0]
            res = draw_mesh_ordered(
                out, d.mesh, d.model, view_proj, texture=d.texture,
                light=light, color=d.color, shading=d.shading,
                sampling_mode=d.sampling or sampling_mode,
                cull_backfaces=cull_backfaces, normal_mat=d.normal_mat,
                frame_height=fh, frame_width=fw, y_offset=y_offset,
                x_offset=x_offset, near_clip=near_clip, engine=ordered_engine,
                return_counters=return_counters)
        else:
            batch = pack_draws(seg, view_proj, light, sampling_mode, fw, fh,
                               cull_backfaces, near_clip)
            res = _render_and_merge(out, batch, light, y_offset, x_offset,
                                    return_counters)
        if return_counters:
            out, c = res
            counters = counters.merge(c)
        else:
            out = res
    return (out, counters) if return_counters else out

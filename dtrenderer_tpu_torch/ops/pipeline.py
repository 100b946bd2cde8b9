"""The 3D draw-call pipeline: vertex stage -> binning -> raster kernels ->
depth merge and blend.

Port of `dtrenderer_tpu/ops/pipeline.py`. A draw is the vertex stage (the
batched pass of ops/vertex_batch.py, on a CUDA device one launch of
csrc/vertex_pass.cu, on every route), the binning, then one kernel launch,
then the merge:

- `draw_mesh(backend="fused")` and the opaque runs of `draw_meshes`: the
  fused raster+shade kernel (ops/render_fused.py), which merges into the
  framebuffer in the same launch (`win = z < fb.depth; color = where(win,
  blend_over(src, color), color)`; a banded frame's launches each write
  their rows of one pair of planes);
- `draw_mesh(backend="pallas")`: the visibility kernel
  (ops/raster_pallas.py), then `shade_deferred` (on a CUDA device one
  launch of the deferred shading kernel, csrc/shade_deferred.cu);
- `draw_mesh(backend="ref")`: the plain-torch full-frame raster
  (ops/raster_ref.py), then `shade_deferred`;
- `draw_mesh_ordered` and the translucent draws of `draw_meshes`: the
  ordered kernel (ops/raster_ordered.py, engine "tile"), or the reference's
  per-triangle loop (engine "scan").

`raster_opts` on backend "fused" takes the reference's four band keys
(`row_bands`, `band_index`, `band_shared`, `band_distributed`: a frame cut
into row bands, binned per band, through one shared table or through the
distributed exchange of ops/binning.py; every way gives the bits of the
single launch). Any other `raster_opts` or `ordered_opts` key raises
NotImplementedError: they are the reference's TPU binning and kernel knobs,
and the port's kernels take none.

A draw is staged once (`stage_draw_mesh`, `stage_draw_mesh_ordered`: the
vertex stage, which no shard of the frame changes) and rastered per shard
(`raster_staged`); parallel/shard.py stages once per device and rasters once
per band. On a CUDA device a staged "fused" or "tile" draw holds graph
memory (ops/vertex_graph.py): it is valid until the same draw is staged
again, and raster_staged raises after that. "pallas", "ref" and "scan"
stage through the same pass, eager (vertex_batch.pack), and own what they
stage. prepare_draw is the per-draw vertex stage in plain torch, the JAX
package's counterpart, to which every route's staging is held bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.debug import FrameCounters
from dtrenderer_tpu_torch.models.primitives import white_texture
from dtrenderer_tpu_torch.ops import geometry, sampling
from dtrenderer_tpu_torch.ops.binning import (
    Bins, band_bins, bin_bands, bin_triangles,
)
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.raster_ordered import render_ordered
from dtrenderer_tpu_torch.ops.raster_pallas import rasterize_pallas
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
from dtrenderer_tpu_torch.ops.render_fused import (
    CORNER_STRIDE, P_C0, TILE_H, TILE_W, light_scalars, pack_flags,
    render_fused,
)
from dtrenderer_tpu_torch.ops.shading import (
    SHADING_FLAT, SHADING_GOURAUD, SHADING_NONE, SHADING_PHONG, Light,
    apply_light, light_term, make_light,
)
from dtrenderer_tpu_torch.utils.color import blend_over
from dtrenderer_tpu_torch.utils.math3d import (
    cross, homogenize, mat4mul, transform_directions, transform_points,
)

F32 = torch.float32
SAMPLING_MODES = ("nearest", "bilinear")

# Launches of the deferred shading kernel (csrc/shade_deferred.cu) made by
# shade_deferred (CUDA tensors only).
KERNEL_LAUNCHES = 0


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
        term = light_term(cross(w1 - w0, w2 - w0), light)
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


BAND_OPTS = ("row_bands", "band_index", "band_shared", "band_distributed")


def _check_opts(name: str, opts, allowed=()):
    unknown = sorted(k for k in (opts or {}) if k not in allowed)
    if unknown:
        raise NotImplementedError(
            f"{name} {unknown} are the reference's TPU binning/kernel "
            f"knobs; the port's kernels take none")


class BandOpts(NamedTuple):
    """raster_opts' band keys (backend "fused"). row_bands > 1 cuts the frame
    into that many row bands; band_index names the one band this framebuffer
    is (None: the framebuffer is the whole frame, every band is rendered);
    shared bins through one table over the banded tile grid, not shared
    bins band by band; distributed bins through the band exchange."""
    row_bands: int = 1
    band_index: int | None = None
    shared: bool = True
    distributed: bool = False


def band_opts(raster_opts, fused: bool = True) -> BandOpts:
    """Parse raster_opts; as in the reference the other band keys mean
    nothing without row_bands > 1."""
    _check_opts("raster_opts", raster_opts, BAND_OPTS if fused else ())
    opts = raster_opts or {}
    row_bands = int(opts.get("row_bands", 1) or 1)
    if row_bands <= 1:
        return BandOpts()
    band_index = opts.get("band_index")
    return BandOpts(row_bands,
                    None if band_index is None else int(band_index),
                    bool(opts.get("band_shared", True)),
                    bool(opts.get("band_distributed", False)))


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
    """Vertex stage and packing for a list of DrawSpecs: the batch of
    prepare_draw and pack_payload of every draw, concatenated in draw
    order, and one texture LUT (make_texture_lut's layout), computed in one
    batched pass over all draws (ops/vertex_batch.py). mvps optionally
    overrides each draw's view_proj @ model.

    On a CUDA device the pass runs through ops/vertex_graph.py: eager the
    first time a submission's key (its draws' modes, flags and the shapes
    and addresses of their meshes and textures, the frame size; not the
    values of matrices, light or colours) is seen, captured in a CUDA graph
    the second time, replayed after that. Then the returned DrawBatch is
    the graph's memory: it holds this call's values until the next replay
    of the same key, which overwrites it in place. Every consumer in the
    package (binning, the kernels, the merge) reads it on the stream of the
    call before that replay; a caller that keeps a batch across frames
    clones it."""
    _check_sampling(sampling_mode)
    if light.direction.device.type == "cuda":
        from dtrenderer_tpu_torch.ops import vertex_graph

        return vertex_graph.pack(draws, view_proj, light, sampling_mode,
                                 frame_w, frame_h, cull_backfaces, near_clip,
                                 mvps)
    from dtrenderer_tpu_torch.ops import vertex_batch

    return vertex_batch.pack(draws, view_proj, light, sampling_mode, frame_w,
                             frame_h, cull_backfaces, near_clip, mvps)


def _render_and_merge(fb: Framebuffer, batch: DrawBatch, light: Light,
                      y_offset: int, x_offset: int, return_counters: bool,
                      bins: Bins | None = None, out=None):
    """Bin (unless the caller brings this shard's Bins) and launch the fused
    kernel once, which merges into the framebuffer: into `out`, a (colour,
    depth) pair of planes, when given, else into fresh ones."""
    h, w = fb.depth.shape
    if bins is None:
        bins = bin_triangles(batch.coef, batch.bbox, batch.valid, h, w,
                             y_offset, x_offset, TILE_H, TILE_W)
    merged, overflow, shaded = render_fused(
        batch.coef, batch.payload, bins, batch.tex_lut, light, h, w,
        y_offset, x_offset, fb=fb, out=out, count_shaded=return_counters)
    if not return_counters:
        return merged
    return merged, FrameCounters(
        tris_submitted=torch.tensor(batch.coef.shape[0], dtype=torch.int32,
                                    device=batch.coef.device),
        tris_valid=batch.valid.sum(dtype=torch.int32),
        pixels_shaded=shaded,
        bin_overflow=overflow,
    )


def merge_band_counters(counters) -> FrameCounters:
    """FrameCounters of a frame from its bands' (or tiles'): the triangle
    counts are the scene's and the same in every band, so they are taken
    once; shaded pixels and dropped pairs add up, on the first band's
    device."""
    first = counters[0]
    device = first.pixels_shaded.device

    def total(xs):
        return torch.stack([x.to(device) for x in xs]).sum(dtype=torch.int32)

    return FrameCounters(
        tris_submitted=first.tris_submitted,
        tris_valid=first.tris_valid,
        pixels_shaded=total([c.pixels_shaded for c in counters]),
        bin_overflow=total([c.bin_overflow for c in counters]),
    )


def _render_banded(fb: Framebuffer, batch: DrawBatch, light: Light,
                   y_offset: int, x_offset: int, frame_h: int,
                   bands: BandOpts, return_counters: bool):
    """The fused draw of a frame cut into bands.row_bands row bands
    (raster_opts row_bands > 1). With a band_index the framebuffer is that
    one band of the frame and y_offset its first row in the frame;
    otherwise the framebuffer is the whole frame and every band is
    rendered, one kernel launch each, from Bins made by the way the opts
    name (binning.bin_bands)."""
    h, w = fb.depth.shape
    n = bands.row_bands
    coef, bbox, valid = batch.coef, batch.bbox, batch.valid
    if bands.band_index is not None:
        if bands.distributed:
            raise ValueError(
                "band_distributed with a band_index: one band cannot run "
                "the exchange alone; parallel.shard.draw_mesh_sharded runs "
                "it across the mesh, and a whole framebuffer without "
                "band_index on one device")
        if frame_h != h * n:
            raise ValueError(f"band_index render: frame_height {frame_h} != "
                             f"band_h * row_bands ({h * n})")
        if bands.shared:
            y_frame = y_offset - bands.band_index * h
            table = bin_triangles(coef, bbox, valid, h * n, w, y_frame,
                                  x_offset, TILE_H, TILE_W, n)
            bins = band_bins(table, bands.band_index, n)
        else:
            bins = None
        return _render_and_merge(fb, batch, light, y_offset, x_offset,
                                 return_counters, bins)

    if h % n:
        raise ValueError(f"row_bands={n} must divide the frame height {h}")
    band_h = h // n
    all_bins = bin_bands(coef, bbox, valid, h, w, n, y_offset, x_offset,
                         TILE_H, TILE_W, bands.shared, bands.distributed)
    # one frame's planes; each band's launch writes its rows
    out = Framebuffer(
        color=torch.empty((h, w, 4), dtype=F32, device=fb.depth.device),
        depth=torch.empty((h, w), dtype=F32, device=fb.depth.device))
    counters = []
    for b, bins in enumerate(all_bins):
        rows = slice(b * band_h, (b + 1) * band_h)
        res = _render_and_merge(
            Framebuffer(fb.color[rows], fb.depth[rows]), batch, light,
            y_offset + b * band_h, x_offset, return_counters, bins,
            out=(out.color[rows], out.depth[rows]))
        if return_counters:
            counters.append(res[1])
    if not return_counters:
        return out
    return out, merge_band_counters(counters)


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


def shade_deferred_plain(fb: Framebuffer, z, tri, coef, attrs, texture,
                         sampling_mode: str, shading_mode: str, light: Light,
                         y_offset: int = 0, x_offset: int = 0) -> Framebuffer:
    """shade_deferred in plain torch: its CPU path and the twin of
    csrc/shade_deferred.cu. Only the pixels that win the depth test are
    gathered (`nonzero`, a host read on a CUDA tensor) and shaded; the
    reference gathers the whole frame, and the values are the same."""
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


def _check_plane(name: str, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"shade_deferred: {name} must be {dtype} "
                         f"{list(shape)}, got {t.dtype} {list(t.shape)}")
    if t.device != device:
        raise ValueError(f"shade_deferred: {name} is on {t.device}, the "
                         f"framebuffer on {device}")


def _kernel_plane(name: str, t, dtype, shape, device):
    """A deferred kernel input checked and made contiguous and 16-byte
    aligned (the kernel reads colour, setup rows and texels as float4; a
    shard's planes may be strided views, a texture a view at an offset)."""
    _check_plane(name, t, dtype, shape, device)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _attrs_rows(attrs, T: int, device):
    """attrs [T, 3, 10] checked, as the kernel reads it: each row's 30
    channels contiguous, rows at any stride of 30 or more (the corner
    channels of a DrawBatch's payload, a view of row stride 34, are read in
    place); any other layout is copied. Read as floats: no alignment."""
    _check_plane("attrs", attrs, F32, (T, 3, CORNER_STRIDE), device)
    if attrs.stride()[1:] == (CORNER_STRIDE, 1) and \
            attrs.stride(0) >= 3 * CORNER_STRIDE:
        return attrs
    return attrs.contiguous()


def shade_deferred(fb: Framebuffer, z, tri, coef, attrs, texture,
                   sampling_mode: str, shading_mode: str, light: Light,
                   y_offset: int = 0, x_offset: int = 0) -> Framebuffer:
    """Deferred pass: shade the winning fragments of a visibility G-buffer
    (z [H, W] f32, tri [H, W] i32, -1 uncovered) and merge them into the
    framebuffer: a pixel wins where tri >= 0 and z < fb.depth. coef: the
    setup rows [T, 16]; attrs: q-premultiplied corner attrs [T, 3, 10] (the
    kernel reads a view whose rows are 30 contiguous channels at any row
    stride, such as StagedDraw.attrs10, without a copy); texture
    [th, tw, 4]. (y_offset, x_offset) is fb's origin in the frame
    the rows were set up for. Returns a new Framebuffer; fb is not written.

    On a CPU tensor this is shade_deferred_plain. On a CUDA tensor it is one
    launch of csrc/shade_deferred.cu (counted in KERNEL_LAUNCHES), with no
    host read; a failed build or launch raises. Other devices raise."""
    global KERNEL_LAUNCHES
    device = fb.depth.device
    if device.type == "cpu":
        return shade_deferred_plain(fb, z, tri, coef, attrs, texture,
                                    sampling_mode, shading_mode, light,
                                    y_offset, x_offset)
    if device.type != "cuda":
        raise NotImplementedError(
            f"shade_deferred runs on CUDA (kernel) or CPU (plain twin), not "
            f"{device.type}")
    _check_sampling(sampling_mode)
    h, w = fb.depth.shape
    T = coef.shape[0]
    if texture.dim() != 3 or texture.shape[0] * texture.shape[1] < 1:
        raise ValueError(f"shade_deferred: texture must be [th, tw, 4], got "
                         f"{list(texture.shape)}")
    th, tw = int(texture.shape[0]), int(texture.shape[1])
    planes = dict(
        z=_kernel_plane("z", z, F32, (h, w), device),
        tri=_kernel_plane("tri", tri, torch.int32, (h, w), device),
        depth=_kernel_plane("fb.depth", fb.depth, F32, (h, w), device),
        color=_kernel_plane("fb.color", fb.color, F32, (h, w, 4), device),
        coef=_kernel_plane("coef", coef, F32, (T, geometry.SETUP_CHANNELS),
                           device),
        attrs=_attrs_rows(attrs, T, device),
        tex_lut=_kernel_plane("texture", texture, F32, (th, tw, 4),
                              device).reshape(th * tw, 4))
    out = Framebuffer(color=torch.empty((h, w, 4), dtype=F32, device=device),
                      depth=torch.empty((h, w), dtype=F32, device=device))
    if h * w == 0:
        return out
    from dtrenderer_tpu_torch.kernels import shade_deferred as ds

    flags = pack_flags(shading_mode == SHADING_PHONG,
                       sampling_mode == "bilinear")
    scalars = light_scalars(light).to(device)
    with torch.cuda.device(device):
        ds.launch(**planes, scalars=scalars, out_color=out.color,
                  out_depth=out.depth, tw=tw, th=th, flags=flags, height=h,
                  width=w, y_offset=int(y_offset), x_offset=int(x_offset))
    KERNEL_LAUNCHES += 1
    return out


class StagedDraw(NamedTuple):
    """The vertex stage of one draw_mesh / draw_mesh_ordered call: what every
    shard of the frame shares. route "fused" and "tile" carry a packed
    DrawBatch; "pallas", "ref" and "scan" the setup, the corner attributes
    and the texture that shade_deferred / the scan loop read: the setup
    rows of an eager vertex_batch.pack and attrs10, a [T', 3, 10] view of
    its payload's corner channels (row stride 34), equal to prepare_draw's.

    A DrawBatch that a CUDA graph's replay made (pack_draws) is that graph's
    memory: the next staging of the same submission (same meshes, textures,
    modes and frame size) overwrites it. `stamp` (ops/vertex_graph.Stamp)
    then makes raster_staged raise rather than draw the later frame's
    geometry; None on the CPU and for an eager batch, which the draw owns."""
    route: str            # one of BACKENDS or ORDERED_ENGINES
    light: Light
    n_submitted: int      # FrameCounters.tris_submitted of the draw
    batch: DrawBatch | None = None
    setup: geometry.TriSetup | None = None
    attrs10: torch.Tensor | None = None
    texture: torch.Tensor | None = None
    sampling_mode: str = "nearest"
    shading: str = SHADING_GOURAUD
    window: tuple[int, int] | None = None
    bands: BandOpts = BandOpts()
    stamp: object = None  # vertex_graph.Stamp of a replayed batch


def _stage(route, device, mesh, model, view_proj, frame_height, frame_width,
           texture, light, color, shading, sampling_mode, cull_backfaces,
           normal_mat, mvp, near_clip, **more) -> StagedDraw:
    _check_sampling(sampling_mode)
    if light is None:
        light = make_light(device=device)
    mvps = None if mvp is None else [mvp]
    if route in ("fused", "tile"):
        spec = DrawSpec(mesh, model, texture=texture, color=color,
                        shading=shading, normal_mat=normal_mat)
        batch = pack_draws([spec], view_proj, light, sampling_mode,
                           frame_width, frame_height, cull_backfaces,
                           near_clip, mvps=mvps)
        stamp = None
        if batch.coef.is_cuda:
            from dtrenderer_tpu_torch.ops import vertex_graph

            stamp = vertex_graph.stamp(batch)
        return StagedDraw(route, light, batch.coef.shape[0], batch=batch,
                          stamp=stamp, **more)
    # The batched pass, eager (on the card one launch of the vertex kernel,
    # never a vertex graph): its setup rows and a view of its payload's
    # corner channels are prepare_draw's setup and attrs10 bit for bit.
    # shade_deferred reads the texture itself, so the spec carries none.
    from dtrenderer_tpu_torch.ops import vertex_batch

    spec = DrawSpec(mesh, model, color=color, shading=shading,
                    normal_mat=normal_mat)
    batch = vertex_batch.pack([spec], view_proj, light, sampling_mode,
                              frame_width, frame_height, cull_backfaces,
                              near_clip, mvps)
    rows = batch.coef.shape[0]
    setup = geometry.TriSetup(batch.coef, batch.bbox, batch.valid)
    attrs10 = batch.payload[:, P_C0:].view(rows, 3, CORNER_STRIDE)
    if texture is None:
        texture = white_texture(device=device)
    n = rows if route == "scan" else mesh.faces.shape[0]
    return StagedDraw(route, light, n, setup=setup, attrs10=attrs10,
                      texture=texture, sampling_mode=sampling_mode,
                      shading=shading, **more)


def stage_draw_mesh(device, mesh, model, view_proj, frame_height: int,
                    frame_width: int, texture=None, light: Light | None = None,
                    color=(1.0, 1.0, 1.0, 1.0), shading: str = SHADING_GOURAUD,
                    sampling_mode: str = "nearest",
                    cull_backfaces: bool = True, normal_mat=None,
                    backend: str = "ref", mvp=None,
                    raster_opts: dict | None = None,
                    near_clip: bool = True) -> StagedDraw:
    """draw_mesh's checks and vertex stage for a frame of [frame_height,
    frame_width] pixels, with the scene inputs on `device`; draw_mesh's own
    keywords and defaults. raster_staged then renders any shard of that
    frame, until the same draw is staged again on a CUDA device: backend
    "fused" there stages through a CUDA graph whose next replay overwrites
    the batch, and raster_staged of the older StagedDraw raises (StagedDraw
    says why)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    bands = band_opts(raster_opts, backend == "fused")
    return _stage(backend, device, mesh, model, view_proj, frame_height,
                  frame_width, texture, light, color, shading, sampling_mode,
                  cull_backfaces, normal_mat, mvp, near_clip, bands=bands)


def stage_draw_mesh_ordered(device, mesh, model, view_proj,
                            frame_height: int, frame_width: int, texture=None,
                            light: Light | None = None,
                            color=(1.0, 1.0, 1.0, 1.0),
                            shading: str = SHADING_GOURAUD,
                            sampling_mode: str = "nearest",
                            cull_backfaces: bool = True, normal_mat=None,
                            mvp=None, near_clip: bool = True,
                            window: tuple[int, int] | None = (64, 128),
                            engine: str = "auto",
                            raster_opts: dict | None = None) -> StagedDraw:
    """draw_mesh_ordered's checks and vertex stage, as stage_draw_mesh
    (engine "tile" on a CUDA device: valid until the same draw is staged
    again)."""
    if engine == "auto":
        engine = "tile"
    if engine not in ORDERED_ENGINES:
        raise ValueError(f"unknown ordered engine {engine!r}")
    _check_opts("raster_opts", raster_opts)
    return _stage(engine, device, mesh, model, view_proj, frame_height,
                  frame_width, texture, light, color, shading, sampling_mode,
                  cull_backfaces, normal_mat, mvp, near_clip, window=window)


def raster_staged(fb: Framebuffer, staged: StagedDraw, y_offset: int = 0,
                  x_offset: int = 0, return_counters: bool = False,
                  bins: Bins | None = None):
    """Raster, shade and merge a staged draw into fb, the shard at (y_offset,
    x_offset) of the frame the draw was staged for. `bins` (route "fused"
    only) are this shard's ready Bins; without them the shard is binned
    here. Raises RuntimeError when the same draw was staged again since on
    a CUDA device (StagedDraw)."""
    h, w = fb.depth.shape
    route, light = staged.route, staged.light
    if staged.stamp is not None:
        staged.stamp.check()
    if route == "fused":
        return _render_and_merge(fb, staged.batch, light, y_offset, x_offset,
                                 return_counters, bins)
    if bins is not None:
        raise ValueError(f"ready bins are for the fused route, not {route!r}")
    zero = torch.zeros((), dtype=torch.int32, device=fb.depth.device)
    if route in ORDERED_ENGINES:
        if route == "tile":
            batch = staged.batch
            color_o, depth_o, overflow = render_ordered(
                batch.coef, batch.bbox, batch.valid, batch.payload,
                batch.tex_lut, light, fb.color, fb.depth, h, w, y_offset,
                x_offset)
            valid = batch.valid
        else:
            color_o, depth_o = _draw_scan(
                fb, staged.setup, staged.attrs10, staged.texture,
                staged.sampling_mode, staged.shading, light, staged.window,
                y_offset, x_offset)
            overflow, valid = zero, staged.setup.valid
        out = Framebuffer(color=color_o, depth=depth_o)
        shaded = depth_o < fb.depth
    else:
        setup = staged.setup
        if route == "ref":
            z, tri = rasterize_ref(setup.coef, setup.valid, h, w,
                                   y_offset=y_offset, x_offset=x_offset)
            overflow = zero
        else:
            z, tri, overflow = rasterize_pallas(setup.coef, setup.bbox,
                                                setup.valid, h, w, y_offset,
                                                x_offset)
        out = shade_deferred(fb, z, tri, setup.coef, staged.attrs10,
                             staged.texture, staged.sampling_mode,
                             staged.shading, light, y_offset, x_offset)
        shaded, valid = (tri >= 0) & (z < fb.depth), setup.valid
    if not return_counters:
        return out
    return out, FrameCounters(
        tris_submitted=torch.tensor(staged.n_submitted, dtype=torch.int32,
                                    device=fb.depth.device),
        tris_valid=valid.sum(dtype=torch.int32),
        pixels_shaded=shaded.sum(dtype=torch.int32),
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

    Every backend stages through the batched vertex pass (on a CUDA device
    one launch of csrc/vertex_pass.cu), which reads f32 mesh verts, uv and
    normals and i64 or i32 faces: any other mesh raises ValueError, on
    every backend; there is no fallback to another vertex stage.

    raster_opts (backend "fused"): row_bands=N renders the frame as N row
    bands, one launch each, bit-equal to the single launch; band_shared
    (default True) bins them through one shared table, False band by band;
    band_distributed=True through the distributed exchange; band_index=b
    says that fb is band b alone (frame_height = fb height * N).
    """
    h, w = fb.depth.shape
    fh = frame_height if frame_height is not None else h
    fw = frame_width if frame_width is not None else w
    staged = stage_draw_mesh(
        fb.depth.device, mesh, model, view_proj, fh, fw, texture=texture,
        light=light, color=color, shading=shading,
        sampling_mode=sampling_mode, cull_backfaces=cull_backfaces,
        normal_mat=normal_mat, backend=backend, mvp=mvp,
        raster_opts=raster_opts, near_clip=near_clip)
    if staged.bands.row_bands > 1:
        return _render_banded(fb, staged.batch, staged.light, y_offset,
                              x_offset, fh, staged.bands, return_counters)
    return raster_staged(fb, staged, y_offset, x_offset, return_counters)


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
    The vertex stage, and the meshes it takes, are draw_mesh's.
    """
    h, w = fb.depth.shape
    staged = stage_draw_mesh_ordered(
        fb.depth.device, mesh, model, view_proj,
        frame_height if frame_height is not None else h,
        frame_width if frame_width is not None else w, texture=texture,
        light=light, color=color, shading=shading,
        sampling_mode=sampling_mode, cull_backfaces=cull_backfaces,
        normal_mat=normal_mat, mvp=mvp, near_clip=near_clip, window=window,
        engine=engine, raster_opts=raster_opts)
    return raster_staged(fb, staged, y_offset, x_offset, return_counters)


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
    raster_opts' band keys (draw_mesh) apply to the opaque runs.
    """
    bands = band_opts(raster_opts)
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
            if bands.row_bands > 1:
                res = _render_banded(out, batch, light, y_offset, x_offset,
                                     fh, bands, return_counters)
            else:
                res = _render_and_merge(out, batch, light, y_offset,
                                        x_offset, return_counters)
        if return_counters:
            out, c = res
            counters = counters.merge(c)
        else:
            out = res
    return (out, counters) if return_counters else out


# ------------------------------------------------------------------ audits
# The reference's pre-flight audits count what its fixed-capacity bins would
# drop. The port's bins drop nothing, so every overflow is 0 and every
# budget key is None; what stays is the description of the scene: the
# deepest tile, and per band the triangles and (tile, triangle) pairs.


def _audit_setup(view_proj, draws, height, width, light, cull_backfaces,
                 near_clip):
    """coef, bbox, valid of every draw's setup rows, concatenated."""
    if light is None:
        light = make_light(device=view_proj.device)
    setups = [
        prepare_draw(d.mesh, d.model, view_proj, mat4mul(view_proj, d.model),
                     d.normal_mat if d.normal_mat is not None else d.model,
                     light, d.color, d.shading, width, height,
                     cull_backfaces, near_clip)[0]
        for d in draws]
    return (torch.cat([s.coef for s in setups]),
            torch.cat([s.bbox for s in setups]),
            torch.cat([s.valid for s in setups]))


def _max_count(bins: Bins) -> int:
    return int((bins.tile_start[1:] - bins.tile_start[:-1]).max())


def audit_scene(view_proj, draws, height, width, light=None,
                cull_backfaces=True, near_clip=True,
                raster_opts: dict | None = None):
    """Binning audit of a batched scene (not on the frame's path): returns
    (overflow, max_count, capacity) as the reference does, with overflow
    always 0 and capacity None: the CSR bins have none. max_count is the
    deepest 16x16 tile's triangle count over the whole frame."""
    band_opts(raster_opts)
    coef, bbox, valid = _audit_setup(view_proj, draws, height, width, light,
                                     cull_backfaces, near_clip)
    bins = bin_triangles(coef, bbox, valid, height, width, 0, 0, TILE_H,
                         TILE_W)
    return int(bins.overflow), _max_count(bins), None


def audit_bands(view_proj, draws, height, width, n_bands: int, light=None,
                cull_backfaces=True, near_clip=True,
                raster_opts: dict | None = None):
    """Audit of a banded/sharded render: runs the binning the banded render
    would run (the shared table when raster_opts selects it, else band by
    band) and returns the reference's dict:
      n_bands, band_h
      shared          True when raster_opts selects the shared table
      band_tris       [n_bands] valid triangles whose bbox touches each band
      band_pairs      [n_bands] binned (tile, triangle) pairs of each band
      shard_budget, pair_budget       None (the port has no budgets)
      shard_overflow, pair_overflow   0 (nothing is dropped)
      ok              True
    """
    if height % n_bands:
        raise ValueError(f"n_bands={n_bands} must divide the frame height "
                         f"{height}")
    band_h = height // n_bands
    bands = band_opts(raster_opts)
    shared = bands.row_bands > 1 and bands.shared and not bands.distributed
    coef, bbox, valid = _audit_setup(view_proj, draws, height, width, light,
                                     cull_backfaces, near_clip)
    all_bins = bin_bands(coef, bbox, valid, height, width, n_bands, 0, 0,
                         TILE_H, TILE_W, shared)
    band_tris, band_pairs = [], []
    for b, bins in enumerate(all_bins):
        y0, y1 = b * band_h, (b + 1) * band_h - 1
        band_tris.append(int((valid & (bbox[:, 3] >= y0)
                              & (bbox[:, 1] <= y1)).sum()))
        band_pairs.append(int(bins.tile_start[-1] - bins.tile_start[0]))
    overflow = sum(int(bins.overflow) for bins in all_bins)
    return dict(
        n_bands=n_bands, band_h=band_h, shared=shared, shard_budget=None,
        band_tris=band_tris, shard_overflow=0, pair_budget=None,
        band_pairs=band_pairs, pair_overflow=overflow, ok=overflow == 0,
    )


def audit_ordered(view_proj, mesh, model, height, width, light=None,
                  cull_backfaces=True, near_clip=True,
                  raster_opts: dict | None = None):
    """Audit of the ordered tile engine (draw_mesh_ordered engine="tile"):
    (overflow, max_tile_count, capacity) over the kernel's 16x16 tiles,
    with overflow 0 and capacity None as audit_scene."""
    _check_opts("raster_opts", raster_opts)
    spec = DrawSpec(mesh, model, shading=SHADING_NONE)
    return audit_scene(view_proj, [spec], height, width, light,
                       cull_backfaces, near_clip)

"""Submission-order (translucency) raster: every triangle that covers a pixel
and passes the depth test against the pixel's running depth is shaded,
blended source-over and writes its depth, in triangle-id order.

Port of `dtrenderer_tpu/ops/raster_ordered.py`. Submission order matters
only per pixel, so the port's CSR bins, which list each tile's ids in
ascending order, are the per-tile windows the ordered walk needs.
`render_ordered` bins and makes one call of `render_ordered_bins`. On a CUDA
tensor that launches the hand-written kernel `csrc/render_ordered.cu` and
counts it in `KERNEL_LAUNCHES`; on a CPU tensor it runs
`render_ordered_plain`, the same function in plain torch. Any other device
raises.

The payload is render_fused's full 34-channel layout, so each triangle's
flags carry its sampling and Phong modes and one texture LUT serves the draw
(the reference's kernel compiles them in and takes a single draw).
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.ops.binning import Bins, bin_triangles
from dtrenderer_tpu_torch.ops.geometry import coverage_and_depth
from dtrenderer_tpu_torch.ops.render_fused import (
    TILE_H, TILE_W, binned_slots, check_inputs, image_to_tiles,
    kernel_device, light_scalars, require_aligned, shade_plain,
    tile_pixel_centres, tiles_to_image,
)
from dtrenderer_tpu_torch.ops.shading import Light

F32 = torch.float32

# Kernel launches made by render_ordered_bins (CUDA tensors only).
KERNEL_LAUNCHES = 0


def render_ordered(coef, bbox, valid, payload, tex_lut, light: Light,
                   fb_color, fb_depth, height: int, width: int,
                   y_offset: int = 0, x_offset: int = 0):
    """Submission-order draw of coef/bbox/valid (full-frame coordinates)
    into (fb_color [H, W, 4], fb_depth [H, W]), this shard's planes, whose
    origin is (y_offset, x_offset). Returns (color, depth, overflow i32
    scalar, always 0: the bins drop nothing); fb_color and fb_depth are not
    modified."""
    bins = bin_triangles(coef, bbox, valid, height, width, y_offset,
                         x_offset, TILE_H, TILE_W)
    color, depth = render_ordered_bins(coef, payload, bins, tex_lut, light,
                                       fb_color, fb_depth, height, width,
                                       y_offset, x_offset)
    return color, depth, bins.overflow


def _check_planes(fb_color, fb_depth, height: int, width: int):
    if fb_color.dtype != F32 or fb_color.shape != (height, width, 4):
        raise ValueError(f"fb_color must be f32 [{height}, {width}, 4], got "
                         f"{fb_color.dtype} {tuple(fb_color.shape)}")
    if fb_depth.dtype != F32 or fb_depth.shape != (height, width):
        raise ValueError(f"fb_depth must be f32 [{height}, {width}], got "
                         f"{fb_depth.dtype} {tuple(fb_depth.shape)}")


def render_ordered_bins(coef, payload, bins: Bins, tex_lut, light: Light,
                        fb_color, fb_depth, height: int, width: int,
                        y_offset: int = 0, x_offset: int = 0):
    """One ordered launch over binned triangles -> (color, depth), written
    to fresh tensors."""
    global KERNEL_LAUNCHES
    check_inputs(coef, bins, height, width, payload, tex_lut, light,
                 fb_color=fb_color, fb_depth=fb_depth)
    _check_planes(fb_color, fb_depth, height, width)
    if not kernel_device("render_ordered_bins", coef, bins, height):
        return render_ordered_plain(coef, payload, bins, tex_lut, light,
                                    fb_color, fb_depth, height, width,
                                    y_offset, x_offset)
    from dtrenderer_tpu_torch.kernels import render_ordered as k3

    coef = coef.contiguous()
    tex_lut = tex_lut.contiguous()
    fb_color = fb_color.contiguous()
    require_aligned(coef=coef, tex_lut=tex_lut, fb_color=fb_color)
    color = torch.empty_like(fb_color)
    depth = torch.empty_like(fb_depth, memory_format=torch.contiguous_format)
    with torch.cuda.device(coef.device):
        k3.launch(coef, payload.contiguous(), bins.tile_start.contiguous(),
                  bins.tri_ids.contiguous(), tex_lut, light_scalars(light),
                  fb_color, fb_depth.contiguous(), color, depth, height,
                  width, int(y_offset), int(x_offset))
    KERNEL_LAUNCHES += 1
    return color, depth


def render_ordered_plain(coef, payload, bins: Bins, tex_lut, light: Light,
                         fb_color, fb_depth, height: int, width: int,
                         y_offset: int = 0, x_offset: int = 0):
    """The kernel's plain-torch twin: the CSR lists padded and walked slot
    by slot (ascending ids), vectorised over all tiles x tile pixels; per
    slot the coverage, the depth test against the running depth, the
    shading of the pixels that pass (render_fused.shade_plain), the
    source-over blend and the depth write."""
    px, py = tile_pixel_centres(bins, height, width, y_offset, x_offset,
                                coef.device)
    color = image_to_tiles(fb_color, bins, 0.0)         # [n_tiles, P, 4]
    depth = image_to_tiles(fb_depth, bins, -float("inf"))  # never passes
    for has, ids in binned_slots(bins):
        inside, z, b = coverage_and_depth(coef[ids][:, None, :], px, py)
        win = inside & has[:, None] & (z < depth)
        if not bool(win.any()):
            continue
        tri = ids[:, None].expand(win.shape)[win]
        src = shade_plain(payload[tri], tuple(x[win] for x in b), tex_lut,
                          light)
        color[win] = src + color[win] * (1.0 - src[:, 3:4])
        depth[win] = z[win]
    return (tiles_to_image(color, bins, height, width).contiguous(),
            tiles_to_image(depth, bins, height, width).contiguous())

"""Binned visibility raster: the depth and winning-triangle G-buffer that
`pipeline.shade_deferred` shades (`draw_mesh(backend="pallas")`).

Port of `dtrenderer_tpu/ops/raster_pallas.py`, whose name it keeps so the
counterpart is easy to find; it launches CUDA, not Pallas. `rasterize_pallas`
bins the triangles into the kernels' 16x16-tile CSR lists and makes one call
of `rasterize_bins`. On a CUDA tensor that launches the hand-written kernel
`csrc/raster_visibility.cu` and counts it in `KERNEL_LAUNCHES`; on a CPU
tensor it runs `rasterize_pallas_plain`, the same function in plain torch
(render_fused's visibility phase). Any other device raises.
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.ops.binning import Bins, bin_triangles
from dtrenderer_tpu_torch.ops.render_fused import (
    TILE_H, TILE_W, check_inputs, kernel_device, require_aligned,
    tiles_to_image, winner_plain,
)

F32 = torch.float32
I32 = torch.int32

# Kernel launches made by rasterize_bins (CUDA tensors only).
KERNEL_LAUNCHES = 0


def rasterize_pallas(coef, bbox, valid, height: int, width: int,
                     y_offset: int = 0, x_offset: int = 0):
    """Binned visibility raster of coef/bbox/valid (full-frame coordinates)
    over this [height, width] shard, whose origin is (y_offset, x_offset).
    Returns (z f32 [H, W], +inf background; tri i32 [H, W], -1 background;
    overflow i32 scalar, always 0: the bins drop nothing), as
    raster_ref.rasterize_ref plus the overflow count."""
    bins = bin_triangles(coef, bbox, valid, height, width, y_offset,
                         x_offset, TILE_H, TILE_W)
    z, tri = rasterize_bins(coef, bins, height, width, y_offset, x_offset)
    return z, tri, bins.overflow


def rasterize_bins(coef, bins: Bins, height: int, width: int,
                   y_offset: int = 0, x_offset: int = 0):
    """One visibility launch over binned triangles -> (z, tri)."""
    global KERNEL_LAUNCHES
    check_inputs(coef, bins, height, width)
    if not kernel_device("rasterize_bins", coef, bins, height):
        return rasterize_pallas_plain(coef, bins, height, width, y_offset,
                                      x_offset)
    from dtrenderer_tpu_torch.kernels import raster_visibility as k2

    coef = coef.contiguous()
    require_aligned(coef=coef)
    z = torch.empty((height, width), dtype=F32, device=coef.device)
    tri = torch.empty((height, width), dtype=I32, device=coef.device)
    with torch.cuda.device(coef.device):
        k2.launch(coef, bins.tile_start.contiguous(), bins.tri_ids.contiguous(),
                  z, tri, height, width, int(y_offset), int(x_offset))
    KERNEL_LAUNCHES += 1
    return z, tri


def rasterize_pallas_plain(coef, bins: Bins, height: int, width: int,
                           y_offset: int = 0, x_offset: int = 0):
    """The kernel's plain-torch twin: the slot loop of the kernels'
    visibility phase (render_fused.winner_plain). Returns (z, tri)."""
    bz, bid, _ = winner_plain(coef, bins, height, width, y_offset, x_offset)
    z = tiles_to_image(bz, bins, height, width).contiguous()
    tri = torch.where(z == float("inf"), -1,
                      tiles_to_image(bid, bins, height, width)).contiguous()
    return z, tri

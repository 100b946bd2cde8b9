"""Plain-torch reference rasterizer: the visibility G-buffer of every
triangle over the whole frame (or band), no binning.

Port of `dtrenderer_tpu/ops/raster_ref.py` (pure jnp there, no kernel). A
chunked loop over the valid triangles: within a chunk the (min z, lowest id)
winner, merged into the running best with a strict `<`, so earlier chunks
win ties. Together that is the (min z, min id) rule of FORMULAS.md "Depth
test".
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.ops.geometry import coverage_and_depth

F32 = torch.float32
I32 = torch.int32


def rasterize_ref(coef, valid, height: int, width: int, chunk: int = 8,
                  y_offset: int = 0, x_offset: int = 0):
    """coef f32 [T, 16], valid bool [T]; (y_offset, x_offset) is this
    [height, width] region's origin in the frame. Returns (depth f32 [H, W],
    +inf background; tri i32 [H, W], -1 background)."""
    device = coef.device
    py = (torch.arange(height, device=device) + y_offset).to(F32) + 0.5
    px = (torch.arange(width, device=device) + x_offset).to(F32) + 0.5
    py, px = py[:, None], px[None, :]
    zbuf = torch.full((height, width), float("inf"), dtype=F32, device=device)
    tri = torch.full((height, width), -1, dtype=I32, device=device)
    int_max = torch.iinfo(I32).max
    # Invalid triangles never win, so the loop walks the valid ones only
    # (in ascending id order, which keeps the tie rule).
    valid_ids = valid.nonzero().squeeze(1)
    for c0 in range(0, valid_ids.shape[0], chunk):
        c_ids = valid_ids[c0:c0 + chunk]
        ids = c_ids.to(I32)[:, None, None]
        inside, z, _ = coverage_and_depth(coef[c_ids][:, None, None, :], px,
                                          py)
        zmask = torch.where(inside, z, float("inf"))
        zbest = zmask.amin(dim=0)
        # the lowest id among the chunk's minima (argmin's first index)
        ibest = torch.where(inside & (zmask == zbest), ids,
                            int_max).amin(dim=0)
        take = zbest < zbuf  # strict: earlier chunks win ties
        zbuf = torch.where(take, zbest, zbuf)
        tri = torch.where(take, ibest, tri)
    return zbuf, tri

"""Triangle -> framebuffer-tile binning into CSR lists (plain torch).

Port of the semantics of `dtrenderer_tpu/ops/binning.py`, without its TPU
machinery: every in-frame triangle emits one (tile, triangle) pair per tile
of its bbox's tile span, pairs are sorted on one int64 key `tile * T + id`,
and per-tile starts come from a bincount + cumsum. Each tile's ids come out
ascending. Nothing is dropped, so there is no capacity, small/broad split,
pair budget or row banding (the int64 key has no 2^31 cap), and `overflow`
is always zero; it stays in the API so FrameCounters keeps its shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32


class Bins(NamedTuple):
    tile_start: torch.Tensor  # i32 [n_tiles + 1] CSR offsets, tiles row-major
    tri_ids: torch.Tensor     # i32 [n_pairs] triangle ids, ascending per tile
    overflow: torch.Tensor    # i32 [] pairs dropped (always 0 here)
    tile_h: int
    tile_w: int


def bin_triangles(coef, bbox, valid, height: int, width: int,
                  y_offset: int = 0, x_offset: int = 0,
                  tile_h: int = 16, tile_w: int = 16) -> Bins:
    """coef f32 [T,16], bbox i32 [T,4] (x0,y0,x1,y1 inclusive, frame pixels),
    valid bool [T]. Bins the triangles that touch this [height, width] shard
    of the frame, whose origin is (y_offset, x_offset)."""
    T = coef.shape[0]
    device = coef.device
    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)
    n_tiles = n_ty * n_tx

    # in-shard test + bbox localisation (render_fused.prepare_draw_bins)
    in_shard = (
        valid
        & (bbox[:, 2] >= x_offset) & (bbox[:, 0] < x_offset + width)
        & (bbox[:, 3] >= y_offset) & (bbox[:, 1] < y_offset + height)
    )
    x0 = torch.clamp(bbox[:, 0] - x_offset, 0, width - 1)
    y0 = torch.clamp(bbox[:, 1] - y_offset, 0, height - 1)
    x1 = torch.clamp(bbox[:, 2] - x_offset, 0, width - 1)
    y1 = torch.clamp(bbox[:, 3] - y_offset, 0, height - 1)

    tx0 = x0 // tile_w
    ty0 = y0 // tile_h
    span_w = x1 // tile_w - tx0 + 1
    span_h = y1 // tile_h - ty0 + 1
    n_cover = torch.where(in_shard, span_w * span_h, 0).to(torch.int64)

    # one pair per covered tile; k = the pair's index within its triangle
    tri = torch.repeat_interleave(torch.arange(T, device=device), n_cover)
    first = torch.cumsum(n_cover, 0) - n_cover
    k = torch.arange(tri.shape[0], device=device) - first[tri]
    sw = span_w.to(torch.int64)[tri]
    tile = (ty0.to(torch.int64)[tri] + k // sw) * n_tx + (
        tx0.to(torch.int64)[tri] + k % sw)

    key = torch.sort(tile * T + tri).values
    tile_sorted = key // T
    counts = torch.bincount(tile_sorted, minlength=n_tiles)
    tile_start = torch.zeros(n_tiles + 1, dtype=torch.int64, device=device)
    tile_start[1:] = torch.cumsum(counts, 0)
    return Bins(
        tile_start=tile_start.to(I32),
        tri_ids=(key - tile_sorted * T).to(I32),
        overflow=torch.zeros((), dtype=I32, device=device),
        tile_h=tile_h,
        tile_w=tile_w,
    )

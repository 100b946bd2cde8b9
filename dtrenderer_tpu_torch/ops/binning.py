"""Triangle -> framebuffer-tile binning into CSR lists.

Port of the semantics of `dtrenderer_tpu/ops/binning.py`, without its TPU
machinery: every in-frame triangle emits one (tile, triangle) pair per tile
of its bbox's tile span, and each tile's ids come out ascending. Nothing is
dropped, so there is no capacity, small/broad split or pair budget, and
`overflow` is always zero; it stays in the API so FrameCounters keeps its
shape.

Which path runs where: on a CUDA tensor `bin_triangles` launches the
hand-written kernels of `csrc/binning.cu` (`bin_on_card`: a single-pass
count and scan of each triangle's tiles, one read of the pair count back to
the host, a merge-path emit of the pairs, a stable radix sort of them on
the tile's bits and the tile starts from the sorted tiles) and counts the
call in `KERNEL_LAUNCHES`; on a CPU tensor it runs
`bin_triangles_plain`, the same function in plain torch (pairs sorted on one
int64 key `tile * T + id`, per-tile starts from a bincount + cumsum) and the
kernels' twin. There is no fallback between the two: any other device
raises. `bin_triangles_distributed`, `window_ids` and the audits stay plain
torch on every device.

A frame cut into N row bands can be binned three ways, all with the same
per-tile id sets:

  per band     `bin_triangles` once per band, with the band's offsets;
  shared       `bin_triangles(row_bands=N)` once over the *banded* tile grid
               (each band's tile rows start at the band's first pixel row,
               so a band height need not be a multiple of the tile), then
               `band_bins` cuts band b's window out of the one table;
  distributed  `bin_triangles_distributed`: source d of N bins its 1/N slice
               of the triangles over the banded grid, cuts one bucket per
               destination band, `exchange_band_buckets` hands every band
               its buckets, and each band merges what it received.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32
I64 = torch.int64

# Calls of bin_triangles that launched csrc/binning.cu (CUDA tensors only).
KERNEL_LAUNCHES = 0


class Bins(NamedTuple):
    """CSR lists of one tile grid. A band's window of a shared table
    (`band_bins`) keeps the table's `tri_ids` and absolute offsets, so
    `tile_start[0]` need not be 0: read a tile's ids as
    `tri_ids[tile_start[t]:tile_start[t + 1]]`, and all of them in order
    with `window_ids`."""
    tile_start: torch.Tensor  # i32 [n_tiles + 1] CSR offsets, tiles row-major
    tri_ids: torch.Tensor     # i32 [n_pairs] triangle ids, ascending per tile
    overflow: torch.Tensor    # i32 [] pairs dropped (always 0 here)
    tile_h: int
    tile_w: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _emit_pairs(bbox, valid, height: int, width: int, y_offset: int,
                x_offset: int, tile_h: int, tile_w: int, row_bands: int):
    """One (tile, triangle) pair per tile of every in-shard triangle's bbox
    span, over the banded tile grid of a [height, width] shard whose origin
    is (y_offset, x_offset). Returns (tile i64 [P], tri i64 [P]); tri indexes
    the rows of bbox."""
    if height % row_bands:
        raise ValueError(f"row_bands={row_bands} must divide the height "
                         f"{height}")
    device = bbox.device
    band_h = height // row_bands
    n_tyb = _ceil_div(band_h, tile_h)
    n_tx = _ceil_div(width, tile_w)

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

    def tile_row(y):
        # banded grid: consecutive bands own consecutive runs of n_tyb rows
        band = y // band_h
        return band * n_tyb + (y - band * band_h) // tile_h

    tx0 = x0 // tile_w
    ty0 = tile_row(y0)
    span_w = x1 // tile_w - tx0 + 1
    span_h = tile_row(y1) - ty0 + 1
    # a span that is not positive (x1's tile column before x0's or y1's
    # tile row before y0's: an inverted bbox) covers no tile
    covers = in_shard & (span_w > 0) & (span_h > 0)
    n_cover = torch.where(covers, span_w * span_h, 0).to(I64)

    # one pair per covered tile; k = the pair's index within its triangle
    tri = torch.repeat_interleave(
        torch.arange(bbox.shape[0], device=device), n_cover)
    first = torch.cumsum(n_cover, 0) - n_cover
    k = torch.arange(tri.shape[0], device=device) - first[tri]
    sw = span_w.to(I64)[tri]
    tile = (ty0.to(I64)[tri] + k // sw) * n_tx + (tx0.to(I64)[tri] + k % sw)
    return tile, tri


def _csr(key, n_tris: int, n_tiles: int, tile_h: int, tile_w: int) -> Bins:
    """Bins of sorted keys `tile * n_tris + id` over tiles 0..n_tiles-1
    (plain torch: the bincount reads the keys' max to the host on a CUDA
    tensor; the card's bin_triangles builds tile_start without it)."""
    device = key.device
    tile_sorted = key // n_tris
    counts = torch.bincount(tile_sorted, minlength=n_tiles)
    tile_start = torch.zeros(n_tiles + 1, dtype=I64, device=device)
    tile_start[1:] = torch.cumsum(counts, 0)
    return Bins(
        tile_start=tile_start.to(I32),
        tri_ids=(key - tile_sorted * n_tris).to(I32),
        overflow=torch.zeros((), dtype=I32, device=device),
        tile_h=tile_h,
        tile_w=tile_w,
    )


def _n_tiles(height: int, width: int, tile_h: int, tile_w: int,
             row_bands: int) -> int:
    return (row_bands * _ceil_div(height // row_bands, tile_h)
            * _ceil_div(width, tile_w))


def bin_triangles(coef, bbox, valid, height: int, width: int,
                  y_offset: int = 0, x_offset: int = 0,
                  tile_h: int = 16, tile_w: int = 16,
                  row_bands: int = 1) -> Bins:
    """coef f32 [T,16], bbox i32 [T,4] (x0,y0,x1,y1 inclusive, frame pixels),
    valid bool [T]. Bins the triangles that touch this [height, width] shard
    of the frame, whose origin is (y_offset, x_offset).

    row_bands > 1 bins over the banded grid of the shard's N row bands
    (band_h = height // N, ceil(band_h / tile_h) tile rows per band, band
    after band): the shared table whose windows `band_bins` cuts.

    On a CUDA tensor: csrc/binning.cu (`bin_on_card`, one host read); on a
    CPU tensor: `bin_triangles_plain`. The same Bins bit for bit; both bin
    a triangle whose tile span is not positive (an inverted bbox, x1's
    tile column before x0's or y1's tile row before y0's) as empty."""
    global KERNEL_LAUNCHES
    if bbox.device.type == "cpu":
        return bin_triangles_plain(coef, bbox, valid, height, width,
                                   y_offset, x_offset, tile_h, tile_w,
                                   row_bands)
    if bbox.device.type != "cuda":
        raise NotImplementedError(
            f"bin_triangles runs on CUDA (kernel) or CPU (plain twin), not "
            f"{bbox.device.type}")
    T = bbox.shape[0]
    if coef.shape[0] != T or coef.device != bbox.device:
        raise ValueError(f"coef ({coef.shape[0]} rows on {coef.device}) and "
                         f"bbox ({T} rows on {bbox.device}) must match")
    from dtrenderer_tpu_torch.kernels import binning as kb

    with torch.cuda.device(bbox.device):
        bins = bin_on_card(bbox, valid, height, width, y_offset, x_offset,
                           tile_h, tile_w, row_bands, kb)
    if T:
        KERNEL_LAUNCHES += 1
    return bins


def bin_on_card(bbox, valid, height: int, width: int, y_offset: int,
                x_offset: int, tile_h: int, tile_w: int, row_bands: int,
                kernels) -> Bins:
    """bin_triangles through `kernels` (kernels/binning.py on the card; the
    tests hand in the same source built for the host): `scan` counts each
    triangle's tiles into the pairs' ends and the pair count P, the one
    value read back; `emit` writes the pairs, sorts them stably by tile into
    tri_ids and writes tile_start and the overflow word from the sorted
    tiles. Overflow is a view of the word after tile_start."""
    if height % row_bands:
        raise ValueError(f"row_bands={row_bands} must divide the height "
                         f"{height}")
    T = bbox.shape[0]
    if bbox.dtype != I32 or bbox.shape != (T, 4) or \
            valid.dtype != torch.bool or valid.shape != (T,) or \
            valid.device != bbox.device:
        raise ValueError(f"bbox must be i32 [T, 4] and valid bool [T] on one "
                         f"device, got {bbox.dtype} {tuple(bbox.shape)}, "
                         f"{valid.dtype} {tuple(valid.shape)} on "
                         f"{valid.device}")
    bbox, valid = bbox.contiguous(), valid.contiguous()
    if bbox.data_ptr() % 16:
        raise ValueError("bbox must be 16-byte aligned (read as int4)")
    device = bbox.device
    grid = (height, width, y_offset, x_offset, tile_h, tile_w, row_bands)
    n_tiles = _n_tiles(height, width, tile_h, tile_w, row_bands)
    n_pairs = 0
    if T:
        work = torch.empty(T + 2 + _ceil_div(T, kernels.budget()), dtype=I64,
                           device=device)
        kernels.scan(bbox, valid, grid, work)
        n_pairs = int(work[T])  # the one read back to the host
    if n_pairs >= 2**31:
        raise ValueError(f"{n_pairs} pairs: the Bins' int32 offsets hold "
                         f"fewer than 2^31")
    if not n_pairs:
        return Bins(tile_start=torch.zeros(n_tiles + 1, dtype=I32,
                                           device=device),
                    tri_ids=torch.empty(0, dtype=I32, device=device),
                    overflow=torch.zeros((), dtype=I32, device=device),
                    tile_h=tile_h, tile_w=tile_w)
    tile_start = torch.empty(n_tiles + 2, dtype=I32, device=device)
    tri_ids = torch.empty(n_pairs, dtype=I32, device=device)
    scratch = torch.empty(kernels.scratch_bytes(n_pairs, grid),
                          dtype=torch.uint8, device=device)
    kernels.emit(bbox, valid, work, n_pairs, grid, scratch, tile_start,
                 tri_ids)
    return Bins(tile_start=tile_start[:-1], tri_ids=tri_ids,
                overflow=tile_start[-1], tile_h=tile_h, tile_w=tile_w)


def bin_triangles_plain(coef, bbox, valid, height: int, width: int,
                        y_offset: int = 0, x_offset: int = 0,
                        tile_h: int = 16, tile_w: int = 16,
                        row_bands: int = 1) -> Bins:
    """bin_triangles in plain torch: the CPU path and the kernels' twin."""
    T = coef.shape[0]
    tile, tri = _emit_pairs(bbox, valid, height, width, y_offset, x_offset,
                            tile_h, tile_w, row_bands)
    key = torch.sort(tile * T + tri).values
    return _csr(key, T, _n_tiles(height, width, tile_h, tile_w, row_bands),
                tile_h, tile_w)


def band_bins(bins: Bins, band_index: int, row_bands: int) -> Bins:
    """Band `band_index`'s window of a shared table made with
    bin_triangles(row_bands=N): its run of tile_start (a view, absolute
    offsets) over the table's own tri_ids. Nothing is copied."""
    n_tiles = bins.tile_start.shape[0] - 1
    if n_tiles % row_bands or not 0 <= band_index < row_bands:
        raise ValueError(f"band {band_index} of {row_bands} does not cut a "
                         f"table of {n_tiles} tiles")
    per_band = n_tiles // row_bands
    lo = band_index * per_band
    return bins._replace(tile_start=bins.tile_start[lo:lo + per_band + 1])


def window_ids(bins: Bins):
    """The ids of every pair of these bins, tile after tile (all of tri_ids,
    or the run a band's window points at)."""
    lo, hi = bins.tile_start[[0, -1]].tolist()
    return bins.tri_ids[lo:hi]


def exchange_band_buckets(buckets, devices):
    """The band exchange of the distributed binning, the port's all_to_all:
    buckets[src][dst] is what source src holds for band dst (on src's
    device); returns per destination the concatenation of every source's
    bucket, in source order, on devices[dst]. A bucket that already lies on
    its destination's device is not copied."""
    return [
        torch.cat([per_src[dst].to(devices[dst], non_blocking=True)
                   for per_src in buckets])
        for dst in range(len(devices))
    ]


def bin_triangles_distributed(bboxes, valids, height: int, width: int,
                              row_bands: int, y_offset: int = 0,
                              x_offset: int = 0, tile_h: int = 16,
                              tile_w: int = 16) -> list[Bins]:
    """Distributed cross-band binning of a [height, width] frame cut into N =
    row_bands bands. bboxes[d], valids[d] are band d's replica of the
    scene's bbox i32 [T,4] and valid bool [T], on band d's device (one
    tensor may serve several bands of a device).

    Source d emits and sorts the pairs of triangles [d*S, (d+1)*S), S =
    ceil(T / N), over the whole banded grid with global ids, and cuts the
    sorted keys (band-major) into one ragged bucket per destination band;
    `exchange_band_buckets` moves them; band b sorts what it received into
    its own CSR. Returns the N bands' Bins, each on its band's device, with
    the per-tile id sets of bin_triangles(row_bands=N). The reference's fixed
    bucket size, broad-triangle list, all_gather and psum are capacity
    machinery of its TPU form and have no counterpart."""
    N = row_bands
    if len(bboxes) != N or len(valids) != N:
        raise ValueError(f"need one bbox/valid replica per band ({N}), got "
                         f"{len(bboxes)}/{len(valids)}")
    T = bboxes[0].shape[0]
    per_band = _ceil_div(height // N, tile_h) * _ceil_div(width, tile_w)
    slice_len = _ceil_div(T, N)
    buckets = []
    for d in range(N):
        lo, hi = min(d * slice_len, T), min((d + 1) * slice_len, T)
        tile, tri = _emit_pairs(bboxes[d][lo:hi], valids[d][lo:hi], height,
                                width, y_offset, x_offset, tile_h, tile_w, N)
        key = torch.sort(tile * T + (tri + lo)).values
        band_keys = torch.arange(N + 1, device=key.device) * (per_band * T)
        cuts = torch.searchsorted(key, band_keys).tolist()
        buckets.append([key[cuts[b]:cuts[b + 1]] for b in range(N)])
    received = exchange_band_buckets(buckets, [b.device for b in bboxes])
    return [
        _csr(torch.sort(keys).values - b * per_band * T, T, per_band, tile_h,
             tile_w)
        for b, keys in enumerate(received)
    ]


def bin_bands(coef, bbox, valid, height: int, width: int, row_bands: int,
              y_offset: int = 0, x_offset: int = 0, tile_h: int = 16,
              tile_w: int = 16, shared: bool = True,
              distributed: bool = False) -> list[Bins]:
    """The N bands' Bins of a [height, width] frame on one device, by one of
    the three ways: distributed (every source and every band on this
    device), the shared table's windows, or one bin_triangles per band."""
    if height % row_bands:
        raise ValueError(f"row_bands={row_bands} must divide the height "
                         f"{height}")
    if distributed:
        return bin_triangles_distributed(
            [bbox] * row_bands, [valid] * row_bands, height, width,
            row_bands, y_offset, x_offset, tile_h, tile_w)
    if shared:
        table = bin_triangles(coef, bbox, valid, height, width, y_offset,
                              x_offset, tile_h, tile_w, row_bands)
        return [band_bins(table, b, row_bands) for b in range(row_bands)]
    band_h = height // row_bands
    return [bin_triangles(coef, bbox, valid, band_h, width,
                          y_offset + b * band_h, x_offset, tile_h, tile_w)
            for b in range(row_bands)]

"""Fused visibility + shading draw: the host side and its plain twin.

Port of `dtrenderer_tpu/ops/render_fused.py`. On a CUDA tensor `render_fused`
launches the hand-written kernel `csrc/render_fused.cu` (one launch per call)
and counts it in `KERNEL_LAUNCHES`; on a CPU tensor it runs
`render_fused_plain`, the same function in plain torch. There is no fallback
between the two: any other device raises. Given a framebuffer, the same
launch also does the draw call's depth merge into fresh planes.

Payload: the full 34-channel layout of the reference (`FULL_LAYOUT`), per
triangle:
  0 tex_base 1 tw 2 th 3 flags (bit0 phong, bit1 bilinear — see pack_flags)
  4..13 corner0 (q, u*q, v*q, r*q, g*q, b*q, a*q, nx*q, ny*q, nz*q)
  14..23 corner1   24..33 corner2
The reference's layout elisions (`plan_layout`) are bit-exact bandwidth
savings for the TPU and are not ported. The mode of each pixel comes from its
triangle's flags, so one launch serves mixed sampling and shading.

Texture LUT: texel-major f32 [L, 4] (one tap is one 16-byte load), with the
reference's per-texture (base, tw, th) metadata.
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.ops.binning import Bins, window_ids
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.geometry import (
    SETUP_CHANNELS, coverage_and_depth, interp as bary_interp,
)
from dtrenderer_tpu_torch.ops.shading import Light, sqrt_exact
from dtrenderer_tpu_torch.utils.color import blend_over
from dtrenderer_tpu_torch.utils.math3d import to_i32

F32 = torch.float32
I32 = torch.int32

PAYLOAD_CHANNELS = 34
P_TEXBASE, P_TW, P_TH, P_FLAGS = 0, 1, 2, 3
P_C0 = 4            # corner0 base channel
CORNER_STRIDE = 10  # q, u*q, v*q, rgba*q (4), n*q (3)

# The tile of the port's three kernels (csrc/raster_common.cuh kTileH/kTileW);
# bins for a kernel launch are made with this tile.
TILE_H = 16
TILE_W = 16
# The pixel sub-block one warp of K1 and K2 owns (raster_common.cuh kSubH /
# kSubW): a tile is SUBS = 8 of them, row-major, sub-block s = bit s of a
# coarse mask.
SUB_H = 4
SUB_W = 8
SUBS = (TILE_H // SUB_H) * (TILE_W // SUB_W)

# Kernel launches made by render_fused (CUDA tensors only).
KERNEL_LAUNCHES = 0


def pack_flags(is_phong: bool, is_bilinear: bool) -> float:
    """Per-triangle P_FLAGS payload value."""
    return float(int(is_phong) + 2 * int(is_bilinear))


def pack_payload(attrs10, meta, flags_value: float):
    """One draw's payload [T, 34] from its q-premultiplied corner attrs
    [T, 3, 10], its texture placement meta (base, tw, th) and its
    pack_flags value."""
    T = attrs10.shape[0]
    head = torch.tensor([*meta, flags_value], dtype=F32,
                        device=attrs10.device).expand(T, 4)
    return torch.cat([head, attrs10.reshape(T, 3 * CORNER_STRIDE)], dim=1)


def make_texture_lut(textures):
    """Pack textures (premultiplied linear f32 [th, tw, 4], one device) into
    one texel-major LUT [L, 4] plus per-texture (base, tw, th) metadata.

    The same tensor object passed twice is stored once; one texture alone is
    the LUT as it is (a view of it when it is f32 and contiguous), not a
    copy. The total is capped at 2^24 texels: the metadata rides f32 payload
    channels, which hold integers exactly only below 2^24."""
    rows = []
    meta = []
    base = 0
    seen: dict[int, tuple[int, int, int]] = {}
    for tex in textures:
        th, tw = int(tex.shape[0]), int(tex.shape[1])
        cached = seen.get(id(tex))
        if cached is not None:
            meta.append(cached)
            continue
        rows.append(tex.reshape(-1, 4))
        m = (base, tw, th)
        meta.append(m)
        seen[id(tex)] = m
        base += th * tw
    if base > 1 << 24:
        raise ValueError(f"texture LUT has {base} texels; the (base, tw, th) "
                         f"payload channels are exact only below 2^24")
    lut = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
    return lut.to(F32).contiguous(), meta


def check_inputs(coef, bins: Bins, height: int, width: int, payload=None,
                 tex_lut=None, light: Light | None = None, **planes):
    """Shapes, types and devices of a kernel call's inputs (shared by the
    three kernels' wrappers); `planes` are extra tensors that must sit on
    coef's device (framebuffer planes)."""
    device = coef.device
    T = coef.shape[0]
    if coef.dtype != F32 or coef.shape != (T, SETUP_CHANNELS):
        raise ValueError(f"coef must be f32 [T, 16], got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    if payload is not None and (payload.dtype != F32 or
                                payload.shape != (T, PAYLOAD_CHANNELS)):
        raise ValueError(f"payload must be f32 [{T}, {PAYLOAD_CHANNELS}], got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if tex_lut is not None and (tex_lut.dtype != F32 or tex_lut.dim() != 2
                                or tex_lut.shape[1] != 4
                                or tex_lut.shape[0] < 1):
        raise ValueError(f"tex_lut must be f32 [L>=1, 4], got "
                         f"{tex_lut.dtype} {tuple(tex_lut.shape)}")
    n_tiles = (-(-height // bins.tile_h)) * (-(-width // bins.tile_w))
    if bins.tile_start.shape != (n_tiles + 1,) or \
            bins.tile_start.dtype != I32 or bins.tri_ids.dtype != I32:
        raise ValueError("bins do not match this frame size (re-bin with "
                         "binning.bin_triangles for the same height/width)")
    named = dict(tile_start=bins.tile_start, tri_ids=bins.tri_ids,
                 payload=payload, tex_lut=tex_lut, **planes)
    if light is not None:
        named.update({"light.direction": light.direction,
                      "light.ambient": light.ambient})
    for name, t in named.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, coef on {device}")


def kernel_device(name: str, coef, bins: Bins, height: int) -> bool:
    """True when a wrapper must launch its CUDA kernel, False for its plain
    twin (a CPU tensor); raises for other devices and for inputs the
    kernels' 16x16-tile grid does not take."""
    if coef.device.type == "cpu":
        return False
    if coef.device.type != "cuda":
        raise NotImplementedError(
            f"{name} runs on CUDA (kernel) or CPU (plain twin), not "
            f"{coef.device.type}")
    if (bins.tile_h, bins.tile_w) != (TILE_H, TILE_W):
        raise ValueError(f"the kernel needs bins of {TILE_H}x{TILE_W} tiles, "
                         f"got {bins.tile_h}x{bins.tile_w}")
    if -(-height // TILE_H) > 65535:
        raise ValueError(f"height {height} exceeds the kernel's grid limit")
    return True


def require_aligned(**tensors):
    """The kernels read these tensors as float4: 16-byte aligned."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads it as float4)")


def light_scalars(light: Light):
    """f32 [4]: light direction xyz, ambient (the kernels' scalars)."""
    return torch.cat([light.direction.reshape(3).to(F32),
                      light.ambient.reshape(1).to(F32)])


def _check_merge(fb, out, count_shaded: bool, height: int, width: int):
    """The framebuffer planes of a merging call: f32 colour [H, W, 4] and
    depth [H, W]; `out` and `count_shaded` only with a framebuffer."""
    if fb is None:
        if out is not None or count_shaded:
            raise ValueError("out and count_shaded need a framebuffer (fb)")
        return
    pairs = [("fb", fb)] + ([] if out is None else [("out", tuple(out))])
    for name, (color, depth) in pairs:
        if color.dtype != F32 or tuple(color.shape) != (height, width, 4) \
                or depth.dtype != F32 or tuple(depth.shape) != (height, width):
            raise ValueError(
                f"{name} must be f32 colour [{height}, {width}, 4] and depth "
                f"[{height}, {width}], got {color.dtype} "
                f"{list(color.shape)} and {depth.dtype} {list(depth.shape)}")


def render_fused(coef, payload, bins: Bins, tex_lut, light: Light,
                 height: int, width: int, y_offset: int = 0,
                 x_offset: int = 0, *, fb: Framebuffer | None = None,
                 out=None, count_shaded: bool = False):
    """Fused visibility + shading of every binned triangle. (y_offset,
    x_offset) is this [height, width] shard's origin in the frame the coefs
    were set up for.

    Without `fb`: returns (z [H,W] f32, +inf where uncovered; src [H,W,4]
    premultiplied f32, 0 where uncovered; overflow i32 scalar).

    With `fb`, the shard's framebuffer, the same launch merges into it, as
    win = z < fb.depth; color = where(win, blend_over(src, fb.color),
    fb.color); depth = where(win, z, fb.depth), and returns (Framebuffer,
    overflow, shaded): the merged planes, written into `out` (a (colour,
    depth) pair of contiguous planes, e.g. row views of a larger frame,
    not overlapping fb) when given, else into fresh ones; fb is not
    written. shaded: the winning pixels, i32 scalar, with count_shaded;
    else None.
    """
    global KERNEL_LAUNCHES
    _check_merge(fb, out, count_shaded, height, width)
    planes = {} if fb is None else dict(fb_color=fb.color, fb_depth=fb.depth)
    if out is not None:
        planes.update(out_color=out[0], out_depth=out[1])
    check_inputs(coef, bins, height, width, payload, tex_lut, light, **planes)
    if not kernel_device("render_fused", coef, bins, height):
        return render_fused_plain(coef, payload, bins, tex_lut, light,
                                  height, width, y_offset, x_offset, fb=fb,
                                  out=out, count_shaded=count_shaded)
    from dtrenderer_tpu_torch.kernels import render_fused as k1

    device = coef.device
    coef = coef.contiguous()
    tex_lut = tex_lut.contiguous()
    require_aligned(coef=coef, tex_lut=tex_lut)
    args = (coef, payload.contiguous(), bins.tile_start.contiguous(),
            bins.tri_ids.contiguous(), tex_lut, light_scalars(light))
    offsets = (height, width, int(y_offset), int(x_offset))
    if fb is None:
        z = torch.empty((height, width), dtype=F32, device=device)
        src = torch.empty((height, width, 4), dtype=F32, device=device)
        with torch.cuda.device(device):
            k1.launch(*args, z, src, *offsets)
        KERNEL_LAUNCHES += 1
        return z, src, bins.overflow
    fb_color = fb.color.contiguous()
    if fb_color.data_ptr() % 16:
        fb_color = fb_color.clone()
    if out is None:
        out = (torch.empty((height, width, 4), dtype=F32, device=device),
               torch.empty((height, width), dtype=F32, device=device))
    if not (out[0].is_contiguous() and out[1].is_contiguous()):
        raise ValueError("out planes must be contiguous (the kernel writes "
                         "them row-major)")
    require_aligned(out_color=out[0])
    shaded = (torch.zeros((), dtype=I32, device=device) if count_shaded
              else None)
    with torch.cuda.device(device):
        k1.launch(*args, None, None, *offsets, fb_color=fb_color,
                  fb_depth=fb.depth.contiguous(), out_color=out[0],
                  out_depth=out[1], shaded=shaded)
    KERNEL_LAUNCHES += 1
    return Framebuffer(*out), bins.overflow, shaded


# ---------------------------------------------------------------- plain twins
# Shared by the plain twins of the three kernels (this module's, and those of
# ops/raster_pallas.py and ops/raster_ordered.py): per-tile arrays are
# [n_tiles, P] with tiles row-major and P = tile_h * tile_w pixels row-major
# within a tile, the kernels' block and thread order.


def tile_pixel_centres(bins: Bins, height: int, width: int, y_offset: int,
                       x_offset: int, device):
    """Pixel centres (px, py), f32 [n_tiles, P], of every tile pixel in
    frame coordinates."""
    th_, tw_ = bins.tile_h, bins.tile_w
    n_tx = -(-width // tw_)
    n_tiles = (-(-height // th_)) * n_tx
    P = th_ * tw_
    ly = torch.arange(P, device=device) // tw_
    lx = torch.arange(P, device=device) % tw_
    ty = torch.arange(n_tiles, device=device) // n_tx
    tx = torch.arange(n_tiles, device=device) % n_tx
    gy = ty[:, None] * th_ + ly[None, :]
    gx = tx[:, None] * tw_ + lx[None, :]
    return ((gx + x_offset).to(F32) + 0.5, (gy + y_offset).to(F32) + 0.5)


def subblock_masks_plain(coef, bins: Bins, height: int, width: int,
                         y_offset: int = 0, x_offset: int = 0):
    """The coarse stage of K1's and K2's visibility walk in plain torch: for
    every binned (tile, triangle) pair, in `binning.window_ids` order (all
    of `bins.tri_ids`, or a band's window of a shared table), an i32 mask
    whose bit s is set unless an edge function rules out every pixel of the
    tile's sub-block s (SUB_H x SUB_W pixels, row-major in the tile).

    Per edge the kernel's own expression (A*px + B*py) + C, one f32
    rounding per op, is taken at the pixel centre of the sub-block corner
    that maximises it (right column when A >= 0 else left, bottom row when
    B >= 0 else top). Rounding is monotone, so that value bounds the edge at
    every pixel of the sub-block, and the bit is cleared only when the
    corner fails the top-left test e > 0 || (e == 0 && tl > 0): a cleared
    bit means no pixel there can be covered (a NaN clears it too, and then
    no pixel passes either; csrc/raster_common.cuh has the argument)."""
    if (bins.tile_h, bins.tile_w) != (TILE_H, TILE_W):
        raise ValueError(f"sub-block masks need {TILE_H}x{TILE_W} tiles, got "
                         f"{bins.tile_h}x{bins.tile_w}")
    device = coef.device
    n_tx = -(-width // TILE_W)
    counts = (bins.tile_start[1:] - bins.tile_start[:-1]).to(torch.int64)
    tile = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts)
    fx0 = ((tile % n_tx) * TILE_W + x_offset)[:, None]   # tile origin in the
    fy0 = ((tile // n_tx) * TILE_H + y_offset)[:, None]  # frame, [n_pairs, 1]
    sub = torch.arange(SUBS, device=device)
    sx = (sub % (TILE_W // SUB_W))[None, :] * SUB_W
    sy = (sub // (TILE_W // SUB_W))[None, :] * SUB_H
    c = coef[window_ids(bins).to(torch.int64)]
    keep = torch.ones((tile.shape[0], SUBS), dtype=torch.bool, device=device)
    for e in range(3):
        A, B, C = (c[:, 3 * e + i][:, None] for i in range(3))
        tl = c[:, 13 + e][:, None]
        px = (fx0 + sx + torch.where(A >= 0, SUB_W - 1, 0)).to(F32) + 0.5
        py = (fy0 + sy + torch.where(B >= 0, SUB_H - 1, 0)).to(F32) + 0.5
        v = (A * px + B * py) + C
        keep &= (v > 0) | ((v == 0) & (tl > 0))
    return (keep.to(I32) << sub.to(I32)[None, :]).sum(dim=1, dtype=I32)


def tiles_to_image(a, bins: Bins, height: int, width: int):
    """[n_tiles, P, ...] -> [H, W, ...] (ragged edge tiles cropped)."""
    th_, tw_ = bins.tile_h, bins.tile_w
    n_ty, n_tx = -(-height // th_), -(-width // tw_)
    rest = a.shape[2:]
    a = a.reshape(n_ty, n_tx, th_, tw_, *rest).transpose(1, 2)
    return a.reshape(n_ty * th_, n_tx * tw_, *rest)[:height, :width]


def image_to_tiles(img, bins: Bins, fill: float):
    """[H, W, ...] -> [n_tiles, P, ...], ragged edge tiles padded with
    `fill`."""
    th_, tw_ = bins.tile_h, bins.tile_w
    height, width = img.shape[0], img.shape[1]
    n_ty, n_tx = -(-height // th_), -(-width // tw_)
    rest = img.shape[2:]
    pad = torch.full((n_ty * th_, n_tx * tw_, *rest), fill, dtype=img.dtype,
                     device=img.device)
    pad[:height, :width] = img
    pad = pad.reshape(n_ty, th_, n_tx, tw_, *rest).transpose(1, 2)
    return pad.reshape(n_ty * n_tx, th_ * tw_, *rest)


def binned_slots(bins: Bins):
    """Yields (has bool [n_tiles], ids i64 [n_tiles]) for slot s = 0, 1, ...
    of every tile's CSR list: the tile's s-th triangle id (ascending ids),
    where it has one."""
    starts = bins.tile_start.to(torch.int64)
    counts = starts[1:] - starts[:-1]
    max_count = int(counts.max()) if counts.numel() else 0
    n_pairs = bins.tri_ids.shape[0]
    for s in range(max_count):
        has = s < counts
        slot = torch.clamp(starts[:-1] + s, max=n_pairs - 1)
        yield has, torch.where(has, bins.tri_ids[slot], 0).to(torch.int64)


def winner_plain(coef, bins: Bins, height: int, width: int, y_offset: int,
                 x_offset: int):
    """The visibility phase of the kernels, slot by slot, vectorised over
    all tiles x tile pixels: per pixel the (min z, min id) winner of the
    tile's binned triangles. Returns (z f32, id i32 (INT_MAX where
    uncovered), (b0, b1, b2) f32), each [n_tiles, P]."""
    device = coef.device
    px, py = tile_pixel_centres(bins, height, width, y_offset, x_offset,
                                device)
    bz = torch.full(px.shape, float("inf"), dtype=F32, device=device)
    bid = torch.full(px.shape, torch.iinfo(I32).max, dtype=I32, device=device)
    bb = [torch.zeros(px.shape, dtype=F32, device=device) for _ in range(3)]
    for has, ids in binned_slots(bins):
        inside, z, b = coverage_and_depth(coef[ids][:, None, :], px, py)
        ids = ids.to(I32)[:, None]
        take = inside & has[:, None] & ((z < bz) | ((z == bz) & (ids < bid)))
        bz = torch.where(take, z, bz)
        bid = torch.where(take, ids, bid)
        bb = [torch.where(take, bn, bo) for bn, bo in zip(b, bb)]
    return bz, bid, bb


def shade_plain(p, b, tex_lut, light: Light):
    """The kernels' shading of N fragments: payload rows p [N, 34] and
    barycentrics b = (b0, b1, b2), each [N] -> premultiplied src [N, 4]."""
    b0, b1, b2 = b

    def interp(off):
        return bary_interp((b0, b1, b2), p[:, P_C0 + off],
                           p[:, P_C0 + CORNER_STRIDE + off],
                           p[:, P_C0 + 2 * CORNER_STRIDE + off])

    qf = interp(0)
    inv_qf = torch.reciprocal(torch.where(qf != 0, qf, torch.ones_like(qf)))
    u = interp(1) * inv_qf
    v = interp(2) * inv_qf
    rgba = torch.stack([interp(3 + c) * inv_qf for c in range(4)], dim=-1)
    base, tw, th, flags = (p[:, P_TEXBASE], p[:, P_TW], p[:, P_TH],
                           p[:, P_FLAGS])
    tex_len = tex_lut.shape[0]

    def tap(xf, yf):
        # clamp in float, then XLA's conversion: a NaN coordinate stays NaN
        # through the clamp and fetches texel 0 of its row or column, as in
        # the reference and the kernels (fmaxf(NaN, 0) = 0)
        txi = to_i32(torch.minimum(torch.clamp_min(xf, 0.0), tw - 1.0))
        tyi = to_i32(torch.minimum(torch.clamp_min(yf, 0.0), th - 1.0))
        idx = to_i32(base) + tyi * to_i32(tw) + txi
        return tex_lut[torch.clamp(idx, 0, tex_len - 1).to(torch.int64)]

    def lerp2(a, b, t):
        return a + (b - a) * t

    one_minus_v = 1.0 - v
    nearest = tap(torch.floor(u * tw), torch.floor(one_minus_v * th))
    fxs = u * tw - 0.5
    fys = one_minus_v * th - 0.5
    x0f = torch.floor(fxs)
    y0f = torch.floor(fys)
    ax = (fxs - x0f)[:, None]
    ay = (fys - y0f)[:, None]
    bilinear = lerp2(lerp2(tap(x0f, y0f), tap(x0f + 1.0, y0f), ax),
                     lerp2(tap(x0f, y0f + 1.0), tap(x0f + 1.0, y0f + 1.0), ax),
                     ay)
    texel = torch.where((flags >= 2.0)[:, None], bilinear, nearest)
    shaded = texel * rgba

    # per-pixel Phong where flags bit 0 is set (FORMULAS.md lighting)
    nx, ny, nz = (interp(7 + c) * inv_qf for c in range(3))
    d = (nx * nx + ny * ny) + nz * nz
    nlen = sqrt_exact(torch.where(d > 0, d, torch.ones_like(d)))
    lx, lyl, lz = light.direction[0], light.direction[1], light.direction[2]
    llen = sqrt_exact((lx * lx + lyl * lyl) + lz * lz)
    ndl = ((nx / nlen) * (lx / llen) + (ny / nlen) * (lyl / llen)) + (
        nz / nlen) * (lz / llen)
    term = light.ambient + (1.0 - light.ambient) * torch.clamp_min(ndl, 0.0)
    phong = torch.fmod(flags, 2.0) > 0
    lit = torch.cat([shaded[:, :3] * term[:, None], shaded[:, 3:]], dim=1)
    return torch.where(phong[:, None], lit, shaded)


def render_fused_plain(coef, payload, bins: Bins, tex_lut, light: Light,
                       height: int, width: int, y_offset: int = 0,
                       x_offset: int = 0, *, fb: Framebuffer | None = None,
                       out=None, count_shaded: bool = False):
    """The kernel's plain-torch twin: same inputs, same outputs, same op
    order. Phase 1 is winner_plain; phase 2 shades every covered pixel at
    once by gathering its winner's payload; with `fb`, the merge is the
    draw call's torch merge over the (z, src) planes (render_fused says
    what it returns)."""
    bz, bid, bb = winner_plain(coef, bins, height, width, y_offset, x_offset)
    z_img = tiles_to_image(bz, bins, height, width).contiguous()
    covered = z_img != float("inf")
    src = torch.zeros((height, width, 4), dtype=F32, device=coef.device)
    win = tiles_to_image(bid, bins, height, width)[covered].to(torch.int64)
    if win.numel():
        b = tuple(tiles_to_image(x, bins, height, width)[covered] for x in bb)
        src[covered] = shade_plain(payload[win], b, tex_lut, light)
    if fb is None:
        return z_img, src, bins.overflow
    merged, shaded = merge_plain(fb, z_img, src, out, count_shaded)
    return merged, bins.overflow, shaded


def merge_plain(fb: Framebuffer, z, src, out=None,
                count_shaded: bool = False):
    """The depth merge of K1's (z, src) into fb in plain torch, the twin of
    the kernel's epilogue: win = z < fb.depth; colour where(win,
    blend_over(src, fb.color), fb.color), depth where(win, z, fb.depth),
    copied into `out` when given. Returns (Framebuffer, the winners as an
    i32 scalar with count_shaded, else None)."""
    win = z < fb.depth
    color = torch.where(win[..., None], blend_over(src, fb.color), fb.color)
    depth = torch.where(win, z, fb.depth)
    if out is not None:
        out[0].copy_(color)
        out[1].copy_(depth)
        color, depth = out
    shaded = win.sum(dtype=I32) if count_shaded else None
    return Framebuffer(color, depth), shaded

"""2D primitives: line, rectangle, circle, transformed bitmap blit, and the
one-triangle raster of api.render_triangle.

Port of `dtrenderer_tpu/ops/draw2d.py`. Every verb is a masked coverage test
+ premultiplied source-over blend per pixel; painter's order = Python call
order. These verbs write colour only (no depth), into a fresh colour plane:
the framebuffer they are given is never written.

Positions, sizes, radii and colours are host values (Python numbers or
tuples). Each is rounded to f32 on the host and enters the per-pixel
expressions, which keep the reference's op order (FORMULAS.md), as a scalar
operand.

Windows. A verb's result at a pixel depends only on that pixel's centre and
on host values, so each verb works out on the host a window [y0, y1) x
[x0, x1) that holds every pixel it can change (`Window`) and runs only
there: the box of its shape, padded by WINDOW_PAD pixels plus a rounding
margin, clamped to the frame. Pixels outside the window keep their bits.
Where a host value in pixel units is non-finite or at least FULL_FRAME_AT in
magnitude (where f32 spacing reaches half a pixel), the window is the whole
frame, as every verb ran before it had windows. A verb whose window is empty
returns the framebuffer it was given.

Devices. A verb is described on the host by a `Verb` (its kind, window, f32
constants and, for a blit or text, the bitmap or glyph atlas). On a CPU
tensor `draw_plain` runs it in plain torch over the window: pixel centres
`arange(x0, x1) + 0.5`, the same f32 values as the whole frame's. That is
the twin of csrc/draw2d.cu (D2), which a CUDA tensor gets instead: one
launch per verb (kernels/draw2d.py), counted in KERNEL_LAUNCHES, with the
constants passed by value and no host read. `draw_plain` on the whole frame
(`Window.full`) is the full-frame computation the windows are held to.

The one deliberate difference from the reference: `cos`/`sin` of a
Transform2D's rotation are taken once on the host (`math.cos`/`math.sin` of
the f32 angle, rounded to f32) and not by the device's `cos`, so the card and
the CPU rotate by identical factors. They may differ from `jnp.cos` in the
last ulp, which moves a mask only at a pixel whose local coordinate lies on
its threshold.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.ops import sampling
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.shading import sqrt_exact
from dtrenderer_tpu_torch.utils import tensor_version
from dtrenderer_tpu_torch.utils.color import blend_over

F32 = torch.float32

KERNEL_LAUNCHES = 0  # launches of csrc/draw2d.cu (D2), every verb and text

FULL_FRAME_AT = 2.0 ** 22
WINDOW_PAD = 4  # pixels around a verb's box, before the rounding margin

# Verb kinds; csrc/draw2d.cu's kinds and constant layouts must match.
RECT, RECT_T, LINE, CIRCLE, RING, BLIT, TEXT = range(7)


class Window(NamedTuple):
    """Rows [y0, y1) and columns [x0, x1) of the frame."""
    y0: int
    y1: int
    x0: int
    x1: int

    @property
    def empty(self) -> bool:
        return self.y0 >= self.y1 or self.x0 >= self.x1

    @staticmethod
    def full(height: int, width: int) -> "Window":
        return Window(0, height, 0, width)


class Verb(NamedTuple):
    """One verb, as the host describes it to draw_plain and to D2.

    params: the kind's f32 constants (Python floats), colour first:
      RECT    r g b a, x0 y0 x1 y1 (min, max);
      RECT_T  r g b a, cos sin, sx sy (scale), px py (pos), ox oy
              (anchor * size), w h (size);
      LINE    r g b a, maj0 mnr0 slope lo hi, y_major (0 or 1);
      CIRCLE  r g b a, cx cy, r * r;
      RING    r g b a, cx cy, r, thickness * 0.5;
      BLIT    r g b a (tint), as RECT_T from cos on, bilinear (0 or 1);
      TEXT    r g b a.
    image: BLIT the bitmap f32 [bh, bw, 4]; TEXT the atlas f32 [ah, aw].
    text: TEXT only (TextRun)."""
    kind: int
    window: Window
    params: tuple
    image: torch.Tensor | None = None
    text: "TextRun | None" = None


class TextRun(NamedTuple):
    """A string placed on the frame (ops/text.py). codes: i32 [n] glyph codes
    as given (not shifted by FIRST_CHAR); bounds: None for the monospace
    grid, else f32 [n + 1], the cumulative advances from 0."""
    x0: int
    y0: int
    scale: int
    cell_w: int
    cell_h: int
    codes: np.ndarray
    bounds: np.ndarray | None


class Transform2D(NamedTuple):
    """Mirror of the reference's DTRRenderTransform {rotation, scale, anchor}.

    rotation: radians CCW (screen y-down, so visually clockwise), f32 [];
    scale: f32 [2]; anchor: f32 [2] in [0,1] of the primitive's extent
    (0.5,0.5 = center). One made by transform2d() from host numbers keeps
    them, and the verbs read nothing back; the verbs read one built by hand
    from device tensors on the host (one synchronise)."""
    rotation: torch.Tensor
    scale: torch.Tensor
    anchor: torch.Tensor


class _KeptTransform2D(Transform2D):
    """A Transform2D from transform2d() with its host values: `host` (rot,
    sx, sy, ax, ay as np.float32) and `version`, the tensors' version counter
    then (an in-place edit of them makes the verbs read them instead; an
    inference tensor keeps no counter, so the verbs always read it)."""


def transform2d(rotation=0.0, scale=1.0, anchor=(0.5, 0.5), *,
                device) -> Transform2D:
    device = torch.device(device)
    if any(torch.is_tensor(v) for v in (rotation, scale, anchor)):
        return Transform2D(
            rotation=torch.as_tensor(rotation, dtype=F32, device=device),
            scale=torch.as_tensor(scale, dtype=F32, device=device).expand(2),
            anchor=torch.as_tensor(anchor, dtype=F32, device=device),
        )
    host = np.concatenate([
        np.asarray(rotation, np.float32).reshape(1),
        np.broadcast_to(np.asarray(scale, np.float32), (2,)),
        np.asarray(anchor, np.float32).reshape(2)])
    buf = torch.from_numpy(host.copy())
    if device.type == "cuda":  # one copy from pinned memory: no synchronise
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    t = _KeptTransform2D(rotation=buf[0], scale=buf[1:3], anchor=buf[3:5])
    t.host = tuple(host)
    t.version = tensor_version(buf)
    return t


def _f32(*xs):
    """Host values rounded to f32 (as np.float32, so host arithmetic on them
    rounds in f32 too)."""
    return [np.float32(x) for x in xs]


def _consts(fb: Framebuffer, *values) -> torch.Tensor:
    """f32 constants on the framebuffer's device (the plain path's divisors:
    a divide by a Python scalar is not an IEEE divide on every device)."""
    return torch.tensor([float(v) for v in values], dtype=F32,
                        device=fb.color.device)


class _HostTransform(NamedTuple):
    cos: np.float32
    sin: np.float32
    scale: tuple
    anchor: tuple


def _read_transform(t: Transform2D) -> _HostTransform:
    """A Transform2D's values on the host, and cos/sin of -rotation in f32:
    kept by transform2d(), else one host read of the tensors."""
    host = getattr(t, "host", None)
    version = tensor_version(t.rotation)
    if host is not None and version is not None and version == t.version:
        rot, sx, sy, ax, ay = host
    else:
        rot, sx, sy, ax, ay = _f32(*torch.cat(
            [t.rotation.reshape(1), t.scale, t.anchor]).tolist())
    c, s = _f32(math.cos(-float(rot)), math.sin(-float(rot)))
    return _HostTransform(c, s, (sx, sy), (ax, ay))


# ------------------------------------------------------------------ windows


def _far(*values) -> bool:
    """Any value non-finite or at least FULL_FRAME_AT in magnitude."""
    with np.errstate(invalid="ignore"):
        a = np.abs(np.asarray(values, np.float64))
    return not bool(np.all(a < FULL_FRAME_AT))


def box_window(height: int, width: int, xs, ys, *values) -> Window:
    """The window of the box [min xs, max xs] x [min ys, max ys] (pixel
    coordinates, exact float64 bounds of the shape), padded by WINDOW_PAD and
    by 2^-18 of the largest magnitude (the f32 rounding of the verb's pixel
    test, 16 ulps), clamped to the frame; the whole frame when one of xs, ys
    or `values` is non-finite or at least FULL_FRAME_AT in magnitude."""
    if _far(*xs, *ys, *values):
        return Window.full(height, width)
    mag = max(float(np.max(np.abs(np.asarray([*xs, *ys, *values, width,
                                               height], np.float64)))), 1.0)
    pad = WINDOW_PAD + math.ceil(mag * 2.0 ** -18)
    x0 = math.floor(min(xs)) - pad
    x1 = math.ceil(max(xs)) + pad + 1
    y0 = math.floor(min(ys)) - pad
    y1 = math.ceil(max(ys)) + pad + 1
    return Window(max(y0, 0), min(y1, height), max(x0, 0), min(x1, width))


def _mapped_window(height, width, pos, size, ht: _HostTransform) -> Window:
    """The window of a transformed box: its four corners (local 0 or size)
    mapped to the frame, in float64, by the inverse of the verb's pixel map
    lx = (c*dx - s*dy) / sx + ax*w, ly = (s*dx + c*dy) / sy + ay*h."""
    c, s = float(ht.cos), float(ht.sin)
    sx, sy = (float(v) for v in ht.scale)
    ox, oy = (float(a) * float(z) for a, z in zip(ht.anchor, size))
    xs, ys, offs = [], [], []
    for lx in (0.0, float(size[0])):
        for ly in (0.0, float(size[1])):
            rx, ry = (lx - ox) * sx, (ly - oy) * sy
            dx, dy = c * rx + s * ry, -s * rx + c * ry
            xs.append(float(pos[0]) + dx)
            ys.append(float(pos[1]) + dy)
            offs += [rx, ry]
    return box_window(height, width, xs, ys, *pos, *size, ox, oy, c, s, sx,
                      sy, *offs)


# ------------------------------------------------------------------ verbs


def fill_rect(fb: Framebuffer, min_xy, max_xy, color,
              t: Transform2D | None = None):
    """DTRRender_Rectangle: [min, max) rect, optionally rotated/scaled about anchor."""
    return draw(fb, rect_verb(fb, min_xy, max_xy, color, t))


def rect_verb(fb: Framebuffer, min_xy, max_xy, color,
              t: Transform2D | None = None) -> Verb:
    h, w = fb.depth.shape
    mn = _f32(*min_xy)
    mx = _f32(*max_xy)
    col = _f32(*color)
    if t is None:
        win = box_window(h, w, (mn[0], mx[0]), (mn[1], mx[1]))
        return Verb(RECT, win, _floats(*col, *mn, *mx))
    ht = _read_transform(t)
    size = (mx[0] - mn[0], mx[1] - mn[1])
    pos = (mn[0] + ht.anchor[0] * size[0], mn[1] + ht.anchor[1] * size[1])
    return Verb(RECT_T, _mapped_window(h, w, pos, size, ht),
                _floats(*col, *_transform_params(pos, size, ht)))


def _floats(*xs) -> tuple:
    return tuple(float(x) for x in xs)


def _transform_params(pos, size, ht: _HostTransform):
    """cos sin, sx sy, px py, ox oy (anchor * size in f32), w h."""
    return (ht.cos, ht.sin, *ht.scale, *pos, ht.anchor[0] * size[0],
            ht.anchor[1] * size[1], *size)


def line(fb: Framebuffer, p0, p1, color):
    """DTRRender_Line: 1px DDA line (vectorized Bresenham-equivalent coverage).

    A pixel lies on the line iff its major-axis coordinate is in range and its
    minor-axis integer coordinate equals round(DDA(major)).
    """
    return draw(fb, line_verb(fb, p0, p1, color))


def line_verb(fb: Framebuffer, p0, p1, color) -> Verb:
    h, w = fb.depth.shape
    p0 = _f32(*p0)
    p1 = _f32(*p1)
    dx = p1[0] - p0[0]
    dy = p1[1] - p0[1]
    y_major = not abs(dx) >= abs(dy)  # NaN: y-major, as the reference
    maj0, mnr0 = (np.floor(p0[1]), np.floor(p0[0])) if y_major else (
        np.floor(p0[0]), np.floor(p0[1]))
    dmaj, dmnr = (dy, dx) if y_major else (dx, dy)
    with np.errstate(all="ignore"):
        slope = dmnr / (np.float32(1.0) if dmaj == 0 else dmaj)
        lo = np.floor(min(maj0, maj0 + dmaj))
        hi = np.ceil(max(maj0, maj0 + dmaj))
    win = box_window(h, w, (p0[0], p1[0]), (p0[1], p1[1]), dx, dy)
    return Verb(LINE, win, _floats(*_f32(*color), maj0, mnr0, slope, lo, hi,
                                   y_major))


def fill_circle(fb: Framebuffer, center, radius, color):
    return draw(fb, circle_verb(fb, center, radius, color, None))


def circle_outline(fb: Framebuffer, center, radius, color, thickness=1.0):
    return draw(fb, circle_verb(fb, center, radius, color, thickness))


def circle_verb(fb: Framebuffer, center, radius, color, thickness) -> Verb:
    """A filled circle (thickness None) or its outline."""
    h, w = fb.depth.shape
    cx, cy = _f32(*center)
    r, = _f32(radius)
    col = _f32(*color)
    if thickness is None:
        reach, extra = abs(float(r)), ()
        kind, params = CIRCLE, (cx, cy, r * r)
    else:
        th, = _f32(thickness)
        half = th * np.float32(0.5)
        reach, extra = abs(float(r)) + abs(float(half)), (half,)
        kind, params = RING, (cx, cy, r, half)
    x, y = float(cx), float(cy)
    win = box_window(h, w, (x - reach, x + reach), (y - reach, y + reach),
                     r, *extra)
    return Verb(kind, win, _floats(*col, *params))


def blit(
    fb: Framebuffer,
    bitmap,
    pos,
    t: Transform2D | None = None,
    sampling_mode: str = "nearest",
    tint=(1.0, 1.0, 1.0, 1.0),
):
    """DTRRender_Bitmap: blit a premultiplied f32 RGBA bitmap [bh, bw, 4] at pos,
    honoring Transform2D (rotation/scale/anchor) and alpha blending.

    Inverse-maps every framebuffer pixel of the window into bitmap space and
    samples — rotation and scaling come for free, like the reference's
    transformed blit.
    """
    return draw(fb, blit_verb(fb, bitmap, pos, t, sampling_mode, tint))


def blit_verb(fb: Framebuffer, bitmap, pos, t: Transform2D | None = None,
              sampling_mode: str = "nearest",
              tint=(1.0, 1.0, 1.0, 1.0)) -> Verb:
    if sampling_mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown sampling mode: {sampling_mode!r}")
    if bitmap.dim() != 3 or bitmap.shape[2] != 4 or bitmap.numel() == 0:
        raise ValueError(f"blit: bitmap must be [bh, bw, 4] with texels, got "
                         f"{list(bitmap.shape)}")
    if bitmap.device != fb.color.device:
        raise ValueError(f"blit: bitmap on {bitmap.device}, framebuffer on "
                         f"{fb.color.device}")
    h, w = fb.depth.shape
    if t is None:
        ht = _HostTransform(*_f32(1.0, 0.0), tuple(_f32(1.0, 1.0)),
                            tuple(_f32(0.0, 0.0)))
    else:
        ht = _read_transform(t)
    bh, bw = bitmap.shape[0], bitmap.shape[1]
    size = _f32(bw, bh)
    pos = _f32(*pos)
    return Verb(BLIT, _mapped_window(h, w, pos, size, ht),
                _floats(*_f32(*tint), *_transform_params(pos, size, ht),
                        sampling_mode == "bilinear"),
                image=bitmap.to(F32).contiguous())


# ---------------------------------------------------------- the dispatch


def draw(fb: Framebuffer, verb: Verb) -> Framebuffer:
    """Run a verb: fb itself when its window is empty; on a CPU tensor
    draw_plain; on a CUDA tensor one launch of csrc/draw2d.cu (D2, counted
    in KERNEL_LAUNCHES, no host read; a failed build or launch raises).
    Other devices raise."""
    global KERNEL_LAUNCHES
    if verb.window.empty:
        return fb
    device = fb.color.device
    if device.type == "cpu":
        return draw_plain(fb, verb)
    if device.type != "cuda":
        raise NotImplementedError(
            f"2D verbs run on CUDA (kernel) or CPU (plain twin), not "
            f"{device.type}")
    from dtrenderer_tpu_torch.kernels import draw2d as kd

    if fb.color.dtype != F32 or fb.color.dim() != 3 or \
            fb.color.shape[2] != 4:
        raise ValueError(f"2D verbs draw on f32 [H, W, 4] colour, got "
                         f"{fb.color.dtype} {list(fb.color.shape)}")
    color = _aligned(fb.color)
    if verb.image is not None:
        verb = verb._replace(image=_aligned(verb.image))
    out = torch.empty_like(color)
    with torch.cuda.device(device):
        KERNEL_LAUNCHES += kd.launch(verb, color, out)
    return Framebuffer(color=out, depth=fb.depth)


def _aligned(t):
    """t contiguous and 16-byte aligned, as D2 reads it (colour planes and
    bitmaps as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def draw_plain(fb: Framebuffer, verb: Verb) -> Framebuffer:
    """The verb in plain torch over its window, on the framebuffer's device:
    the CPU path and the twin of D2. Outside the window the colour keeps its
    bits; with Window.full it is the full-frame computation."""
    win = verb.window
    if win.empty:
        return fb
    if verb.kind == TEXT:
        from dtrenderer_tpu_torch.ops import text

        mask, src = text.coverage_plain(fb, verb)
    else:
        mask, src = _PLAIN[verb.kind](fb, verb)
    dst = fb.color[win.y0:win.y1, win.x0:win.x1]
    blended = blend_over(src.expand(dst.shape), dst)
    new = torch.where(mask[..., None], blended, dst)
    if win == Window.full(*fb.depth.shape):
        return Framebuffer(color=new, depth=fb.depth)
    color = fb.color.clone()
    color[win.y0:win.y1, win.x0:win.x1] = new
    return Framebuffer(color=color, depth=fb.depth)


def _centres(fb: Framebuffer, win: Window):
    """Pixel centres of the window, px [1, w] and py [h, 1] (they broadcast)."""
    device = fb.color.device
    px = (torch.arange(win.x0, win.x1, dtype=F32, device=device) + 0.5)
    py = (torch.arange(win.y0, win.y1, dtype=F32, device=device) + 0.5)
    return px[None, :], py[:, None]


def _rect_plain(fb, verb):
    px, py = _centres(fb, verb.window)
    r, g, b, a, x0, y0, x1, y1 = verb.params
    mask = (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
    return mask, _consts(fb, r, g, b, a)


def _local(fb, verb, k):
    """(lx, ly) of the window's pixel centres in the primitive's local [0,
    size] box: the primitive is anchored at pos, scaled then rotated about
    the anchor point. k: the verb's constants on the device (the divisors)."""
    px, py = _centres(fb, verb.window)
    c, s, _, _, posx, posy, ox, oy = verb.params[4:12]
    dx = px - posx
    dy = py - posy
    rx = c * dx - s * dy
    ry = s * dx + c * dy
    lx = rx / k[6] + ox
    ly = ry / k[7] + oy
    return lx, ly


def _inside(lx, ly, size_w, size_h):
    return (lx >= 0) & (lx < size_w) & (ly >= 0) & (ly < size_h)


def _rect_t_plain(fb, verb):
    k = _consts(fb, *verb.params)
    lx, ly = _local(fb, verb, k)
    return _inside(lx, ly, *verb.params[12:14]), k[:4]


def _line_plain(fb, verb):
    win = verb.window
    device = fb.color.device
    ix = torch.arange(win.x0, win.x1, dtype=F32, device=device)[None, :]
    iy = torch.arange(win.y0, win.y1, dtype=F32, device=device)[:, None]
    r, g, b, a, maj0, mnr0, slope, lo, hi, y_major = verb.params
    maj, mnr = (iy, ix) if y_major else (ix, iy)
    expect = torch.floor((mnr0 + (maj - maj0) * slope) + 0.5)
    mask = (mnr == expect) & (maj >= lo) & (maj <= hi)
    return mask, _consts(fb, r, g, b, a)


def _dist2(fb, verb):
    px, py = _centres(fb, verb.window)
    cx, cy = verb.params[4:6]
    ddx = px - cx
    ddy = py - cy
    return ddx * ddx + ddy * ddy


def _circle_plain(fb, verb):
    return _dist2(fb, verb) <= verb.params[6], _consts(fb, *verb.params[:4])


def _ring_plain(fb, verb):
    r, half = verb.params[6:8]
    d = sqrt_exact(_dist2(fb, verb))
    return torch.abs(d - r) <= half, _consts(fb, *verb.params[:4])


def _blit_plain(fb, verb):
    k = _consts(fb, *verb.params)
    lx, ly = _local(fb, verb, k)
    inside = _inside(lx, ly, *verb.params[12:14])
    # Bitmap space: ly is a row from the TOP (screen convention), so v = 1 - ly/bh.
    u = lx / k[12]
    v = 1.0 - ly / k[13]
    mode = "bilinear" if verb.params[14] else "nearest"
    src = sampling.sample(verb.image, u, v, mode) * k[:4]
    return inside, torch.where(inside[..., None], src, torch.zeros_like(src))


_PLAIN = {RECT: _rect_plain, RECT_T: _rect_t_plain, LINE: _line_plain,
          CIRCLE: _circle_plain, RING: _ring_plain, BLIT: _blit_plain}


# ------------------------------------------------- api.render_triangle


def triangle(fb: Framebuffer, corners, texture, sampling_mode: str,
             cull_backfaces: bool) -> Framebuffer:
    """One screen-space triangle, depth-tested against fb.depth and shaded
    by the deferred pass (pipeline.shade_deferred, DS).

    corners: f32 [3, 10] on the host, per corner (sx, sy, sz, q, u, v, r,
    g, b, a). The setup row, its bbox and `valid` are worked out on the
    host (setup_host, bit-equal to geometry.triangle_setup_from_corners);
    the window is the bbox, and a triangle that is not valid returns fb.
    The visibility G-buffer (z, tri) over the frame, +inf and -1 outside the
    window, is triangle_gbuffer_plain on a CPU tensor and one D2 launch on a
    CUDA tensor (which also writes the setup row and the corner attributes
    for DS: no upload)."""
    from dtrenderer_tpu_torch.ops import pipeline

    global KERNEL_LAUNCHES
    h, w = fb.depth.shape
    device = fb.depth.device
    corners = np.asarray(corners, np.float32)
    coef, bbox, valid = setup_host(corners[:, :4], w, h, cull_backfaces)
    if not valid:
        return fb
    win = Window(bbox[1], bbox[3] + 1, bbox[0], bbox[2] + 1)
    attrs = corner_attrs_host(corners)
    if device.type == "cpu":
        coef_t = torch.from_numpy(coef[None])
        attrs_t = torch.from_numpy(attrs[None])
        z, tri = triangle_gbuffer_plain(coef_t, win, h, w)
    elif device.type == "cuda":
        from dtrenderer_tpu_torch.kernels import draw2d as kd

        z = torch.empty((h, w), dtype=F32, device=device)
        tri = torch.empty((h, w), dtype=torch.int32, device=device)
        coef_t = torch.empty((1, 16), dtype=F32, device=device)
        attrs_t = torch.empty((1, 3, 10), dtype=F32, device=device)
        with torch.cuda.device(device):
            kd.triangle(coef, attrs, win, z, tri, coef_t, attrs_t)
        KERNEL_LAUNCHES += 1
    else:
        raise NotImplementedError(
            f"render_triangle runs on CUDA (kernel) or CPU (plain twin), not "
            f"{device.type}")
    tex = texture if texture is not None else _white(device)
    return pipeline.shade_deferred(fb, z, tri, coef_t, attrs_t, tex,
                                   sampling_mode, "none", _no_light(device))


@functools.lru_cache(maxsize=8)
def _white(device):
    return torch.ones((1, 1, 4), dtype=F32, device=device)


@functools.lru_cache(maxsize=8)
def _no_light(device):
    """The default light, made once per device ("none" shading reads none
    of it)."""
    from dtrenderer_tpu_torch.ops.shading import make_light

    return make_light(device=device)


def triangle_gbuffer_plain(coef, win: Window, height: int, width: int):
    """(z f32 [H, W], tri i32 [H, W]) of one valid triangle (coef f32
    [1, 16]): rasterize_ref over the window, +inf and -1 elsewhere. The
    twin of D2's triangle entry."""
    from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref

    device = coef.device
    z = torch.full((height, width), float("inf"), dtype=F32, device=device)
    tri = torch.full((height, width), -1, dtype=torch.int32, device=device)
    zw, tw = rasterize_ref(coef, torch.ones(1, dtype=torch.bool,
                                            device=device),
                           win.y1 - win.y0, win.x1 - win.x0, y_offset=win.y0,
                           x_offset=win.x0)
    z[win.y0:win.y1, win.x0:win.x1] = zw
    tri[win.y0:win.y1, win.x0:win.x1] = tw
    return z, tri


def corner_attrs_host(corners) -> np.ndarray:
    """Per-corner attrs f32 [3, 10] for DS: q, u*q, v*q, rgba*q, n*q (0)."""
    q = corners[:, 3:4]
    return np.concatenate([q, corners[:, 4:6] * q, corners[:, 6:10] * q,
                           np.zeros((3, 3), np.float32)], axis=1)


def setup_host(p, width: int, height: int, cull_backfaces: bool):
    """geometry.triangle_setup_from_corners for one triangle, in np.float32
    on the host in its op order: (coef f32 [16], bbox [x0, y0, x1, y1] as
    ints, valid). p: f32 [3, 4] corners (sx, sy, sz, q).

    A copy and not that function on CPU tensors, which dispatches ~170 ATen
    ops more: on an H100's host render_triangle then takes 0.72 host ms
    against 0.24-0.36, in an API frame the host paces (chip_smoke.py
    --verbs-against). tests/test_torch_draw2d_window.py and chip_smoke.py
    hold the two bit for bit."""
    f = np.float32
    p = np.asarray(p, f)
    (x0, y0, z0, q0), (x1, y1, z1, q1), (x2, y2, z2, q2) = p
    with np.errstate(all="ignore"):
        def edge(ax, ay, bx, by):
            A = by - ay
            B = ax - bx
            return A, B, -(ax * A + ay * B)

        def top_left(ax, ay, bx, by):
            return bool(((ay == by) and (bx < ax)) or (by < ay))

        e = [edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)]
        A2, B2, C2 = e[2]
        area2 = (A2 * x2 + B2 * y2) + C2
        behind = q0 == 0 or q1 == 0 or q2 == 0
        finite = bool(np.all(np.isfinite([x0, y0, x1, y1, x2, y2])))
        if cull_backfaces:
            valid = finite and not behind and bool(area2 > 0)
            flip = False
        else:
            valid = finite and not behind and bool(area2 != 0)
            flip = bool(area2 < 0)
        sgn = f(-1.0) if flip else f(1.0)
        e = [(A * sgn, B * sgn, C * sgn) for A, B, C in e]
        area2 = area2 * sgn
        inv_area2 = f(1.0) / (area2 if valid else f(1.0))
        corners = ((x1, y1, x2, y2), (x2, y2, x0, y0), (x0, y0, x1, y1))
        tl = [f(top_left(bx, by, ax, ay) if flip else top_left(ax, ay, bx, by))
              for ax, ay, bx, by in corners]
        coef = np.array([*e[0], *e[1], *e[2], inv_area2, z0, z1, z2, *tl], f)
        xs = [x0, x1, x2] if valid else [f(0.0)] * 3
        ys = [y0, y1, y2] if valid else [f(0.0)] * 3
        lim = float(max(width, height))
        edges = [min(max(float(v), -1.0), lim) for v in (
            np.floor(min(xs)), np.floor(min(ys)), np.ceil(max(xs)),
            np.ceil(max(ys)))]
    step = (-1, -1, 1, 1)
    hi = (width - 1, height - 1, width - 1, height - 1)
    bbox = [min(max(int(v) + s, 0), m) for v, s, m in zip(edges, step, hi)]
    offscreen = (max(xs) < 0 or min(xs) >= width or max(ys) < 0
                 or min(ys) >= height)
    return coef, bbox, valid and not offscreen

"""Device-side text rendering from a baked glyph atlas.

Port of `dtrenderer_tpu/ops/text.py`. The whole string renders in ONE masked
gather pass: each framebuffer pixel computes which character column it falls
in, looks up the glyph code and gathers its coverage texel from the atlas.
Alpha-blends like all 2D ops (color only). Pixel addressing is integer:
tensor `//` and `%` floor, as the reference's do, also left of and above the
text where the local coordinates are negative.

A string is a 2D verb (ops/draw2d.py `Verb` of kind TEXT): it runs on its
window only, `pos` plus n * cell_w * scale (or the advances' sum) by
cell_h * scale, on the CPU as `coverage_plain` in plain torch, on the card as
one launch of csrc/draw2d.cu. Glyph codes and the cumulative advances are
worked out on the host: the advances from the font's host copy
(`assets.font.host_advances`), the codes as given (a tensor of codes on the
card is read once).
"""

from __future__ import annotations

import numpy as np
import torch

from dtrenderer_tpu_torch.assets.font import (
    FIRST_CHAR, GRID_COLS, Font, host_advances,
)
from dtrenderer_tpu_torch.ops import draw2d
from dtrenderer_tpu_torch.ops.fb import Framebuffer

F32 = torch.float32
I32 = torch.int32


def _host_codes(codes) -> np.ndarray:
    if torch.is_tensor(codes):
        codes = codes.detach().cpu().numpy()
    return np.asarray(codes).astype(np.int32).reshape(-1)


def _int32(v: int) -> int:
    """v wrapped to int32, as a tensor op wraps a Python int operand."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def text_verb(fb: Framebuffer, font: Font, codes, pos, color, scale,
              proportional: bool):
    """The Verb of one string, or None for an empty one."""
    codes = _host_codes(codes)
    n = codes.shape[0]
    if n == 0:
        return None
    scale = int(scale)
    if scale == 0:
        raise ValueError("text scale must be a nonzero integer")
    cw, ch = font.cell_w, font.cell_h
    x0, y0 = int(pos[0]), int(pos[1])
    bounds = None
    if proportional:
        adv = host_advances(font)[np.clip(codes - FIRST_CHAR, 0, 94)]
        bounds = np.concatenate([np.zeros(1, np.float32),
                                 np.cumsum(adv, dtype=np.float32)])
    h, w = fb.depth.shape
    width = float(bounds[n]) if proportional else n * cw
    if scale < 1 or draw2d._far(x0, y0, width * scale, ch * scale):
        win = draw2d.Window.full(h, w)
    else:  # the pixels with 0 <= x - x0 < width * scale, likewise y, + 1
        win = draw2d.Window(max(y0 - 1, 0), min(y0 + ch * scale + 1, h),
                            max(x0 - 1, 0),
                            min(x0 + int(np.ceil(width * scale)) + 1, w))
    run = draw2d.TextRun(_int32(x0), _int32(y0), scale, cw, ch, codes, bounds)
    return draw2d.Verb(draw2d.TEXT, win,
                       tuple(float(np.float32(c)) for c in color),
                       image=font.atlas.to(F32).contiguous(), text=run)


def draw_text(fb: Framebuffer, font: Font, codes, pos, color=(1, 1, 1, 1),
              scale=1):
    """codes: i32 [L] glyph codes (assets.font.encode_text); pos: top-left (x, y)."""
    verb = text_verb(fb, font, codes, pos, color, scale, False)
    return fb if verb is None else draw2d.draw(fb, verb)


def draw_text_proportional(fb: Framebuffer, font: Font, codes, pos,
                           color=(1, 1, 1, 1), scale=1):
    """Proportional text using per-glyph advances (native TTF metrics).

    Each pixel column finds its glyph by a searchsorted over the cumulative
    advance boundaries; still a single gather pass.
    """
    if font.advances is None:
        return draw_text(fb, font, codes, pos, color, scale)
    verb = text_verb(fb, font, codes, pos, color, scale, True)
    return fb if verb is None else draw2d.draw(fb, verb)


def coverage_plain(fb: Framebuffer, verb):
    """(inside [h, w], premultiplied source [h, w, 4]) of a TEXT verb over
    its window, in plain torch on the framebuffer's device (draw2d.draw_plain
    blends it)."""
    run, win = verb.text, verb.window
    device = fb.color.device
    codes = torch.from_numpy(run.codes).to(device)
    n = codes.shape[0]
    cw, ch, scale = run.cell_w, run.cell_h, run.scale
    # Integer pixel offsets from pos: x [1, w] and y [h, 1].
    ix = torch.arange(win.x0, win.x1, dtype=I32, device=device)[None, :] \
        - run.x0
    iy = torch.arange(win.y0, win.y1, dtype=I32, device=device)[:, None] \
        - run.y0
    ly = iy // scale
    if run.bounds is None:
        # Local glyph-grid coords (integer; scale by pixel replication).
        lx = ix // scale
        col = lx // cw
        inside = (lx >= 0) & (col < n) & (ly >= 0) & (ly < ch)
        code = codes[torch.clamp(col, 0, n - 1).long()] - FIRST_CHAR
        gx = lx - col * cw
    else:
        bounds = torch.from_numpy(run.bounds).to(device)  # [L+1]
        # a divide by a tensor: by a Python scalar it is not IEEE on every
        # device
        lx = ix.to(F32) / torch.full((), float(scale), dtype=F32,
                                     device=device)
        col = torch.clamp(
            torch.searchsorted(bounds, lx[0].contiguous(), right=True) - 1,
            0, n - 1)[None, :]
        gx = (lx - bounds[col]).to(I32)
        inside = (
            (lx >= 0) & (lx < bounds[n]) & (gx >= 0) & (gx < cw)
            & (ly >= 0) & (ly < ch)
        )
        code = codes[col[0]][None, :] - FIRST_CHAR
    # Gather coverage of glyph `code` [1, w] at cell pixel (gx [1, w], ly [h, 1]).
    atlas = verb.image
    cell_r = code // GRID_COLS
    cell_c = code % GRID_COLS
    ax = torch.clamp(cell_c * cw + gx, 0, atlas.shape[1] - 1)
    ay = torch.clamp(cell_r * ch + ly, 0, atlas.shape[0] - 1)
    coverage = atlas[ay.long(), ax.long()]  # [h, w]
    col4 = torch.tensor(verb.params, dtype=F32, device=device)
    src = col4 * coverage[..., None]
    return inside, torch.where(inside[..., None], src, torch.zeros_like(src))


def text_width(font: Font, n_chars_or_codes, scale: int = 1):
    """Width in px: monospace count, or exact proportional width for codes."""
    if isinstance(n_chars_or_codes, int):
        return n_chars_or_codes * font.cell_w * int(scale)
    codes = np.asarray(n_chars_or_codes)
    if font.advances is None:
        return len(codes) * font.cell_w * int(scale)
    adv = host_advances(font)[np.clip(codes - FIRST_CHAR, 0, 94)]
    return float(adv.sum()) * int(scale)

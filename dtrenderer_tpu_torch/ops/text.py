"""Device-side text rendering from a baked glyph atlas.

Port of `dtrenderer_tpu/ops/text.py`. The whole string renders in ONE masked
gather pass: each framebuffer pixel computes which character column it falls
in, looks up the glyph code and gathers its coverage texel from the atlas.
Alpha-blends like all 2D ops (color only). Pixel addressing is integer:
tensor `//` and `%` floor, as the reference's do, also left of and above the
text where the local coordinates are negative.
"""

from __future__ import annotations

import numpy as np
import torch

from dtrenderer_tpu_torch.assets.font import FIRST_CHAR, GRID_COLS, Font
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.utils.color import blend_over

F32 = torch.float32
I32 = torch.int32


def _codes(codes, device):
    if torch.is_tensor(codes):
        return codes.to(device=device, dtype=I32)
    return torch.tensor(np.asarray(codes, np.int32), device=device)


def _local_grid(fb: Framebuffer, pos):
    """Integer pixel offsets from pos: x [1, W] and y [H, 1]."""
    h, w = fb.depth.shape
    device = fb.depth.device
    x0, y0 = pos
    ix = torch.arange(w, dtype=I32, device=device)[None, :] - int(x0)
    iy = torch.arange(h, dtype=I32, device=device)[:, None] - int(y0)
    return ix, iy


def _blend_glyphs(fb: Framebuffer, font: Font, code, gx, ly, inside, color):
    """Gather coverage of glyph `code` [1, W] at cell pixel (gx [1, W],
    ly [H, 1]) and blend `color` by it where `inside`."""
    cw, ch = font.cell_w, font.cell_h
    cell_r = code // GRID_COLS
    cell_c = code % GRID_COLS
    ax = torch.clamp(cell_c * cw + gx, 0, font.atlas.shape[1] - 1)
    ay = torch.clamp(cell_r * ch + ly, 0, font.atlas.shape[0] - 1)
    coverage = font.atlas[ay.long(), ax.long()]  # [H, W]

    col = torch.tensor([float(c) for c in color], dtype=F32,
                       device=fb.color.device)
    src = col * coverage[..., None]
    src = torch.where(inside[..., None], src, torch.zeros_like(src))
    blended = blend_over(src, fb.color)
    new_color = torch.where(inside[..., None], blended, fb.color)
    return Framebuffer(color=new_color, depth=fb.depth)


def draw_text(fb: Framebuffer, font: Font, codes, pos, color=(1, 1, 1, 1),
              scale=1):
    """codes: i32 [L] glyph codes (assets.font.encode_text); pos: top-left (x, y)."""
    codes = _codes(codes, fb.color.device)
    n = codes.shape[0]
    if n == 0:
        return fb
    cw, ch = font.cell_w, font.cell_h
    scale = int(scale)
    ix, iy = _local_grid(fb, pos)
    # Local glyph-grid coords (integer; scale by pixel replication).
    lx = ix // scale
    ly = iy // scale
    col = lx // cw
    inside = (lx >= 0) & (col < n) & (ly >= 0) & (ly < ch)

    code = codes[torch.clamp(col, 0, n - 1).long()] - FIRST_CHAR
    return _blend_glyphs(fb, font, code, lx - col * cw, ly, inside, color)


def draw_text_proportional(fb: Framebuffer, font: Font, codes, pos,
                           color=(1, 1, 1, 1), scale=1):
    """Proportional text using per-glyph advances (native TTF metrics).

    Each pixel column finds its glyph by a searchsorted over the cumulative
    advance boundaries; still a single gather pass.
    """
    if font.advances is None:
        return draw_text(fb, font, codes, pos, color, scale)
    codes = _codes(codes, fb.color.device)
    n = codes.shape[0]
    if n == 0:
        return fb
    cw, ch = font.cell_w, font.cell_h
    scale = int(scale)

    adv = font.advances[torch.clamp(codes - FIRST_CHAR, 0, 94).long()]  # [L]
    bounds = torch.cat([torch.zeros(1, dtype=F32, device=adv.device),
                        torch.cumsum(adv, dim=0)])  # [L+1]

    ix, iy = _local_grid(fb, pos)
    # a divide by a tensor: by a Python scalar it is not IEEE on every device
    lx = ix.to(F32) / torch.full((), float(scale), dtype=F32,
                                 device=ix.device)
    ly = iy // scale
    col = torch.clamp(
        torch.searchsorted(bounds, lx[0].contiguous(), right=True) - 1,
        0, n - 1)[None, :]
    gx = (lx - bounds[col]).to(I32)
    inside = (
        (lx >= 0) & (lx < bounds[n]) & (gx >= 0) & (gx < cw)
        & (ly >= 0) & (ly < ch)
    )

    code = codes[col[0]][None, :] - FIRST_CHAR
    return _blend_glyphs(fb, font, code, gx, ly, inside, color)


def text_width(font: Font, n_chars_or_codes, scale: int = 1):
    """Width in px: monospace count, or exact proportional width for codes."""
    if isinstance(n_chars_or_codes, int):
        return n_chars_or_codes * font.cell_w * int(scale)
    codes = np.asarray(n_chars_or_codes)
    if font.advances is None:
        return len(codes) * font.cell_w * int(scale)
    adv = font.advances.cpu().numpy()[np.clip(codes - FIRST_CHAR, 0, 94)]
    return float(adv.sum()) * int(scale)

"""Color pipeline: sRGB transfer, premultiplied alpha, u8 packing.

Port of `dtrenderer_tpu/utils/color.py`; formulas and op order in FORMULAS.md
"Color pipeline". Vectorized over any leading dims.

Divisions by a constant divide by a 0-dim tensor on the operand's device, not
by a Python float: PyTorch's CUDA divide turns `x / python_float` into
`x * (1 / python_float)`, which is not the IEEE quotient the reference takes.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _div(x, k: float):
    return x / torch.tensor(k, dtype=F32, device=x.device)


def srgb_to_linear(c):
    """sRGB [0,1] -> linear [0,1], per channel (not for alpha)."""
    return torch.where(
        c <= 0.04045,
        _div(c, 12.92),
        _div(c + 0.055, 1.055) ** 2.4,
    )


def linear_to_srgb(c):
    return torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * (c ** (1.0 / 2.4)) - 0.055,
    )


def premultiply(rgba):
    """[..., 4] straight-alpha -> premultiplied."""
    return torch.cat([rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], dim=-1)


def unpremultiply(rgba):
    a = rgba[..., 3:4]
    safe = torch.where(a > 0, a, torch.ones_like(a))
    return torch.cat([rgba[..., :3] / safe, a], dim=-1)


def blend_over(src, dst):
    """Premultiplied source-over: out = src + dst * (1 - src_a). [..., 4]."""
    return src + dst * (1.0 - src[..., 3:4])


def decode_srgb_u8(rgba_u8):
    """u8 [..., 4] sRGB straight-alpha -> linear premultiplied f32."""
    c = _div(rgba_u8.to(F32), 255.0)
    lin = torch.cat([srgb_to_linear(c[..., :3]), c[..., 3:4]], dim=-1)
    return premultiply(lin)


def pack_srgb_u8(rgba_f32):
    """Linear premultiplied f32 -> sRGB straight-alpha u8, round-half-away
    via floor(x*255 + 0.5) (FORMULAS.md)."""
    straight = unpremultiply(rgba_f32)
    srgb = torch.cat(
        [linear_to_srgb(straight[..., :3]), straight[..., 3:4]], dim=-1
    )
    return torch.floor(torch.clamp(srgb, 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)


def rgba(r, g, b, a=1.0) -> tuple[float, float, float, float]:
    """Literal linear premultiplied colour. The products are taken in f32,
    as the reference takes them; the result is a tuple of Python floats (each
    exactly an f32 value), which every verb that takes a colour turns into a
    tensor on its framebuffer's device."""
    a32 = np.float32(a)
    return (float(np.float32(r) * a32), float(np.float32(g) * a32),
            float(np.float32(b) * a32), float(a32))

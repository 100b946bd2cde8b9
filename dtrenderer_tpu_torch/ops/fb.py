"""Framebuffer: {color, depth} tensors on one device.

Port of `dtrenderer_tpu/ops/fb.py`.
color: f32 [H, W, 4], linear-light premultiplied RGBA.
depth: f32 [H, W], viewport depth in [0,1], +inf = empty.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dtrenderer_tpu_torch.utils import color as colorlib


class Framebuffer(NamedTuple):
    color: torch.Tensor  # f32 [H, W, 4]
    depth: torch.Tensor  # f32 [H, W]

    @property
    def height(self) -> int:
        return self.color.shape[0]

    @property
    def width(self) -> int:
        return self.color.shape[1]


def create(height: int, width: int, device) -> Framebuffer:
    return Framebuffer(
        color=torch.zeros((height, width, 4), dtype=torch.float32,
                          device=device),
        depth=torch.full((height, width), float("inf"), dtype=torch.float32,
                         device=device),
    )


def clear(framebuffer: Framebuffer, clear_color=None) -> Framebuffer:
    """DTRRender_Clear equivalent: fill color, reset depth to +inf."""
    h, w = framebuffer.depth.shape
    device = framebuffer.depth.device
    if clear_color is None:
        col = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
    else:
        col = torch.as_tensor(clear_color, dtype=torch.float32,
                              device=device).expand(h, w, 4).clone()
    return Framebuffer(
        color=col,
        depth=torch.full((h, w), float("inf"), dtype=torch.float32,
                         device=device),
    )


def pack(framebuffer: Framebuffer) -> torch.Tensor:
    """Linear premultiplied f32 -> display sRGB u8 [H, W, 4]."""
    return colorlib.pack_srgb_u8(framebuffer.color)

"""Debug HUD + frame counters.

Port of `dtrenderer_tpu/debug.py`. The HUD is drawn with the package's own
text renderer into the framebuffer. Counters are 0-dim int32 tensors on the
frame's device, so reading them is the caller's choice of when to
synchronise; `DebugHud.render` reads all four with one host copy.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from dtrenderer_tpu_torch.assets.font import Font, bake_builtin_font, encode_text
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.text import draw_text, draw_text_proportional


class FrameCounters(NamedTuple):
    """Per-frame counters. bin_overflow counts (tile, triangle) pairs dropped
    by binning; the port's binning drops nothing, so it stays 0."""
    tris_submitted: torch.Tensor
    tris_valid: torch.Tensor
    pixels_shaded: torch.Tensor
    bin_overflow: torch.Tensor

    @staticmethod
    def zero(device) -> "FrameCounters":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return FrameCounters(z, z, z, z)

    def merge(self, other: "FrameCounters") -> "FrameCounters":
        return FrameCounters(
            self.tris_submitted + other.tris_submitted,
            self.tris_valid + other.tris_valid,
            self.pixels_shaded + other.pixels_shaded,
            self.bin_overflow + other.bin_overflow,
        )


class DebugHud:
    """Host-side HUD state: push lines each frame, render them onto the frame.

    Mirrors DTRDebug_PushText + DTRDebug_Update (SURVEY.md §2 #6).
    """

    def __init__(self, font: Font | None = None, scale: int = 1,
                 proportional: bool = False, *, device=None):
        """font: the atlas to draw with; None bakes the 12-px built-in
        monospace font on `device` (one of the two must be given).

        proportional: render pushed lines with the per-glyph advances
        (ops/text.draw_text_proportional). The default font is monospace,
        where proportional placement is identical; pass a "sans" bake
        (assets.font.bake_builtin_font(family="sans")) for truly proportional
        text."""
        if font is None:
            if device is None:
                raise ValueError("DebugHud needs a font or a device to bake "
                                 "its default font on")
            font = bake_builtin_font(12, device=device)
        self.font = font
        self.scale = scale
        self.proportional = proportional
        self.lines: list[str] = []
        self._last_t = time.perf_counter()
        self.frame_ms = 0.0

    def push_text(self, fmt: str, *args) -> None:
        self.lines.append(fmt % args if args else fmt)

    def end_frame_timing(self) -> None:
        now = time.perf_counter()
        self.frame_ms = (now - self._last_t) * 1000.0
        self._last_t = now

    def render(self, fb: Framebuffer, counters: FrameCounters | None = None,
               color=(1.0, 1.0, 1.0, 1.0)) -> Framebuffer:
        lines = [f"frame: {self.frame_ms:7.2f} ms"]
        if counters is not None:
            # one stacked read: one synchronise, not one per counter
            submitted, valid, shaded, overflow = torch.stack(
                [c.to(torch.int64) for c in counters]).tolist()
            lines.append(f"tris: {valid}/{submitted}  px: {shaded}")
            if overflow > 0:
                lines.append(f"!! bin overflow: {overflow} "
                             f"dropped (raise capacity)")
        lines.extend(self.lines)
        self.lines = []
        draw = (draw_text_proportional if self.proportional
                and self.font.advances is not None else draw_text)
        y = 4
        for ln in lines:
            fb = draw(fb, self.font, encode_text(ln), (4, y), color, self.scale)
            y += self.font.cell_h * self.scale + 2
        return fb

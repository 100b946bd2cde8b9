"""DTRenderer-shaped public API surface.

Port of `dtrenderer_tpu/api.py`: the reference's `DTRRender_*` call set
(Clear, Line, Rectangle, Circle, Bitmap, Text, Triangle, Mesh, with
Transform2D {rotation, scale, anchor} on 2D primitives). Everything is
functional: each call takes and returns a RenderState whose framebuffer
lives on one device, and a frame is a Python function of (state, inputs)
that runs eagerly on that device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.assets.font import Font, bake_builtin_font, encode_text
from dtrenderer_tpu_torch.ops import draw2d, fb as fblib, pipeline
from dtrenderer_tpu_torch.ops import text as textlib
from dtrenderer_tpu_torch.ops.draw2d import Transform2D, transform2d
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.shading import make_light

__all__ = [
    "RenderState", "Transform2D", "transform2d", "new_state", "clear",
    "render_line", "render_rectangle", "render_circle", "render_bitmap",
    "render_triangle", "render_mesh", "render_mesh_ordered", "render_meshes",
    "render_text", "finish_frame", "make_light",
]


class RenderState(NamedTuple):
    """The per-frame render target (PlatformRenderBuffer + z-buffer analog)."""
    fb: Framebuffer

    @property
    def width(self) -> int:
        return self.fb.width

    @property
    def height(self) -> int:
        return self.fb.height

    @property
    def device(self) -> torch.device:
        return self.fb.color.device


def new_state(width: int, height: int, *, device) -> RenderState:
    return RenderState(fb=fblib.create(height, width, device))


def clear(state: RenderState, color=(0, 0, 0, 1)) -> RenderState:
    return state._replace(fb=fblib.clear(state.fb, color))


def render_line(state: RenderState, p0, p1, color) -> RenderState:
    return state._replace(fb=draw2d.line(state.fb, p0, p1, color))


def render_rectangle(state: RenderState, min_xy, max_xy, color,
                     transform: Transform2D | None = None) -> RenderState:
    return state._replace(
        fb=draw2d.fill_rect(state.fb, min_xy, max_xy, color, transform)
    )


def render_circle(state: RenderState, center, radius, color,
                  filled: bool = True) -> RenderState:
    f = draw2d.fill_circle if filled else draw2d.circle_outline
    return state._replace(fb=f(state.fb, center, radius, color))


def render_bitmap(state: RenderState, bitmap, pos,
                  transform: Transform2D | None = None,
                  sampling_mode: str = "nearest",
                  tint=(1.0, 1.0, 1.0, 1.0)) -> RenderState:
    return state._replace(
        fb=draw2d.blit(state.fb, bitmap, pos, transform, sampling_mode, tint)
    )


def render_text(state: RenderState, s, pos, color=(1, 1, 1, 1),
                font: Font | None = None, scale: int = 1,
                proportional: bool = False) -> RenderState:
    font = font or bake_builtin_font(12, device=state.device)
    codes = encode_text(s) if isinstance(s, str) else s
    draw = (textlib.draw_text_proportional if proportional
            else textlib.draw_text)
    return state._replace(fb=draw(state.fb, font, codes, pos, color, scale))


def render_triangle(state: RenderState, p0, p1, p2, color=(1, 1, 1, 1),
                    uv0=(0, 0), uv1=(1, 0), uv2=(0, 1), texture=None,
                    sampling_mode: str = "nearest",
                    cull_backfaces: bool = False) -> RenderState:
    """DTRRender_Triangle analog for direct screen-space triangles.

    p0..p2: (x, y) or (x, y, z[, q]) screen coords; z defaults to 0.5, q to 1
    (pass per-corner q for perspective-correct interpolation of uv). Optional
    texture (premultiplied linear f32 [th,tw,4]) modulated by `color`;
    depth-tested against the state's z-buffer; alpha blended. The setup and
    the triangle's window (its bbox) come from the host values; the frame
    is rasterized over that window only and shaded by the deferred pass
    (ops/draw2d.triangle): on the card one D2 and one DS launch, no host
    read.
    """
    rows = []
    for p, uv in zip((p0, p1, p2), (uv0, uv1, uv2)):
        p = [float(x) for x in p]
        while len(p) < 4:
            p.append({2: 0.5, 3: 1.0}[len(p)])
        rows.append(p[:4] + [float(uv[0]), float(uv[1])]
                    + [float(x) for x in color])
    # per corner (sx, sy, sz, q, u, v, r, g, b, a), f32 on the host
    corners = np.asarray(rows, np.float32)
    return state._replace(fb=draw2d.triangle(
        state.fb, corners, texture, sampling_mode, cull_backfaces))


def _with_counters(state: RenderState, out, kwargs):
    if kwargs.get("return_counters"):
        fb, counters = out
        return state._replace(fb=fb), counters
    return state._replace(fb=out)


def render_mesh(state: RenderState, mesh, model, view_proj, **kwargs):
    """DTRRender_Mesh analog; kwargs forwarded to ops.pipeline.draw_mesh.

    With return_counters=True, returns (state, FrameCounters): the counters
    are 0-dim tensors on the state's device."""
    out = pipeline.draw_mesh(state.fb, mesh, model, view_proj, **kwargs)
    return _with_counters(state, out, kwargs)


def render_mesh_ordered(state: RenderState, mesh, model, view_proj, **kwargs):
    """Submission-order mesh draw (the reference's sequential per-pixel blend
    + depth-write semantics, required for TRANSLUCENT geometry; kwargs
    forwarded to ops.pipeline.draw_mesh_ordered: engine="tile"/"scan"/"auto",
    return_counters). Opaque meshes should use render_mesh (bit-identical
    for opaque, faster)."""
    out = pipeline.draw_mesh_ordered(state.fb, mesh, model, view_proj,
                                     **kwargs)
    return _with_counters(state, out, kwargs)


def render_meshes(state: RenderState, view_proj, draws, **kwargs):
    """Batched scene submission: all opaque meshes in one fused kernel call.

    draws: sequence of pipeline.DrawSpec. Bit-identical to sequential
    render_mesh calls for opaque geometry (order-independent depth resolve).
    With return_counters=True, returns (state, FrameCounters)."""
    out = pipeline.draw_meshes(state.fb, view_proj, draws, **kwargs)
    return _with_counters(state, out, kwargs)


def finish_frame(state: RenderState) -> torch.Tensor:
    """Pack to display sRGB u8 [H, W, 4] (the StretchDIBits-blit analog)."""
    return fblib.pack(state.fb)

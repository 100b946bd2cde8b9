"""Demo scene runner: rotating textured+lit meshes, alpha-blended transformed
bitmaps, primitive demos, debug HUD. Renders N frames through the public API
and writes the last as a PNG. Port of the reference's `tools/demo.py`.

Usage: python -m dtrenderer_tpu_torch.tools.demo [--out demo.png] [--w 800]
       [--h 600] [--frames 1] [--backend fused|pallas|ref] [--cpu]

Renders on the first CUDA device; --cpu renders on the CPU instead. Without
a card and without --cpu it exits with an error.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from dtrenderer_tpu_torch import api
from dtrenderer_tpu_torch.assets.font import bake_builtin_font, encode_text
from dtrenderer_tpu_torch.debug import DebugHud
from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.ops.pipeline import DrawSpec
from dtrenderer_tpu_torch.ops.text import draw_text_proportional
from dtrenderer_tpu_torch.platform import write_png
from dtrenderer_tpu_torch.tools import pick_device
from dtrenderer_tpu_torch.utils import math3d as m3
from dtrenderer_tpu_torch.utils.color import rgba

FOOTER = "Proportional text: iiii WWWW (native TTF metrics)"
FOOTER_COLOR = (1.0, 0.95, 0.7, 1.0)


@functools.lru_cache(maxsize=4)
def _blit_bitmap(device):
    return primitives.checkerboard(16, 4, (1, 0.5, 0.1, 0.9),
                                   (0.1, 0.3, 1.0, 0.9), device=device)


def demo_draws(t, w: int, h: int, cube_mesh, sphere_mesh, tex, grad, device):
    """The demo's 3D submission at time t (an np.float32) for a w x h frame:
    (view_proj, light, [DrawSpec]). A textured flat-lit cube (config-2
    style, nearest: the reference's blocky texture look), a Gouraud+bilinear
    sphere (config-3 style) and a Phong cube (config-4 style). Every angle
    is an f32 product, as in the reference's jitted frame."""
    dev = device

    def ang(k):
        return t * np.float32(k)

    proj = m3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=dev)
    light = api.make_light((0.4, 0.6, 1.0), 0.15, device=dev)
    m_cube = m3.model_matrix(
        (-1.4, 0.2, -5.0),
        m3.mat4mul(m3.rotate_y(ang(1.1), device=dev),
                   m3.rotate_x(ang(0.7), device=dev)), device=dev)
    m_sphere = m3.model_matrix((1.5, -0.2, -6.0),
                               m3.rotate_y(ang(0.6), device=dev), 1.4,
                               device=dev)
    m_cube2 = m3.model_matrix(
        (0.1, 1.2, -7.5),
        m3.mat4mul(m3.rotate_y(ang(0.9), device=dev),
                   m3.rotate_z(ang(0.4), device=dev)), 0.8, device=dev)
    return proj, light, [
        DrawSpec(cube_mesh, m_cube, texture=tex, shading="flat",
                 sampling="nearest"),
        DrawSpec(sphere_mesh, m_sphere, texture=grad, shading="gouraud",
                 sampling="bilinear"),
        DrawSpec(cube_mesh, m_cube2, color=rgba(0.9, 0.4, 0.9, 1.0),
                 shading="phong", sampling="nearest"),
    ]


def demo_frame(state, t: float, cube_mesh, sphere_mesh, tex, grad, backend: str):
    """One frame of the demo scene at time t (rounded to f32) -> (state,
    FrameCounters or None). On "fused" the three meshes are one batched
    submission (one kernel launch) and the counters come back; on "pallas"
    and "ref" they are three render_mesh calls and there are no counters,
    as in the reference."""
    h, w = state.height, state.width
    dev = state.device
    t = np.float32(t)
    proj, light, draws = demo_draws(t, w, h, cube_mesh, sphere_mesh, tex,
                                    grad, dev)

    state = api.clear(state, rgba(0.06, 0.07, 0.12, 1.0))
    counters = None
    if backend == "fused":
        state, counters = api.render_meshes(
            state, proj, draws, light=light, sampling_mode="bilinear",
            return_counters=True)
    else:
        for d in draws:
            state = api.render_mesh(
                state, d.mesh, d.model, proj, texture=d.texture, light=light,
                color=d.color, shading=d.shading, sampling_mode=d.sampling,
                backend=backend)

    # 2D primitive demos: alpha-blended rects (one rotated), line, circle, blit.
    state = api.render_rectangle(state, (20, h - 90), (120, h - 20),
                                 rgba(0.9, 0.2, 0.2, 0.6))
    state = api.render_rectangle(
        state, (70, h - 110), (180, h - 60), rgba(0.2, 0.6, 0.9, 0.5),
        api.transform2d(rotation=t * np.float32(0.8), device=dev),
    )
    state = api.render_line(state, (w - 180, h - 30), (w - 30, h - 100),
                            rgba(1, 1, 0.3, 1))
    state = api.render_circle(state, (w - 100, h - 140), 28, rgba(0.3, 0.9, 0.4, 0.8))
    state = api.render_bitmap(
        state, _blit_bitmap(dev), (w - 220, 40),
        api.transform2d(rotation=-t, scale=3.0, device=dev),
        sampling_mode="bilinear",
    )
    return state, counters


def draw_footer(state, sans_font):
    """The demo's proportional footer line (per-glyph TTF advances)."""
    fb = draw_text_proportional(
        state.fb, sans_font, encode_text(FOOTER),
        (8, state.height - sans_font.cell_h - 6), FOOTER_COLOR)
    return state._replace(fb=fb)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--w", type=int, default=800)
    ap.add_argument("--h", type=int, default=600)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--backend", default="fused", choices=["ref", "pallas", "fused"])
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = ap.parse_args(argv)

    dev = pick_device(args.cpu)
    print(f"device: {dev}")
    cube_mesh = primitives.cube(device=dev)
    sphere_mesh = primitives.uv_sphere(24, 32, device=dev)
    tex = primitives.checkerboard(64, 8, (1.0, 0.85, 0.3, 1.0),
                                  (0.15, 0.15, 0.5, 1.0), device=dev)
    grad = primitives.gradient_texture(64, device=dev)
    hud = DebugHud(bake_builtin_font(14, device=dev))
    sans_font = bake_builtin_font(16, family="sans", device=dev)

    state = api.new_state(args.w, args.h, device=dev)
    img = None
    for i in range(args.frames):
        t0 = time.perf_counter()
        state, counters = demo_frame(state, 0.6 + i * 0.03, cube_mesh,
                                     sphere_mesh, tex, grad, args.backend)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        hud.end_frame_timing()
        hud.push_text("dtrenderer_tpu_torch demo  backend=%s" % args.backend)
        state = state._replace(fb=hud.render(state.fb, counters))
        state = draw_footer(state, sans_font)
        img = api.finish_frame(state).cpu().numpy()
        dt = (time.perf_counter() - t0) * 1000
        print(f"frame {i}: {dt:8.1f} ms  ({args.w}x{args.h})")

    if img is not None:
        write_png(args.out, img)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

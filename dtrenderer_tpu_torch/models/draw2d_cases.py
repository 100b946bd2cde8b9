"""2D verb inputs, shared by the CPU tests of the verbs' windows and of D2
(`tests/test_torch_draw2d_window.py`, `tests/test_torch_draw2d_kernel.py`)
and by chip_smoke.py's "2D kernel vs plain" phase.

Every case is made from a seed and scaled to the frame, so each consumer
draws the same bits at its own size: each verb kind at seeded random
positions and sizes, with rotated and scaled transforms, windows partly and
wholly off the frame, zero-size shapes, non-finite host values and values
of 2^22 pixels and more (whole-frame windows), monospace and proportional
text at scale 1 and 2 (and a string longer than one D2 launch takes), and
api.render_triangle's corners: front- and back-facing, culled, with
per-corner q, off the frame, degenerate and non-finite.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.assets import font as fontlib
from dtrenderer_tpu_torch.ops import draw2d, text
from dtrenderer_tpu_torch.ops.fb import Framebuffer

BIG = 2.0 ** 23  # beyond draw2d.FULL_FRAME_AT


class VerbCase(NamedTuple):
    name: str
    make: Callable[[Framebuffer], draw2d.Verb]  # the verb on a framebuffer


class TriangleCase(NamedTuple):
    name: str
    corners: np.ndarray  # f32 [3, 10]: sx sy sz q, u v, r g b a
    textured: bool
    sampling: str
    cull_backfaces: bool


def framebuffer(height: int, width: int, device, seed: int) -> Framebuffer:
    """A seeded premultiplied background; depth in [0.2, 0.8] with +inf in a
    quarter of the pixels."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
    a = rng.uniform(0.2, 1, (height, width, 1)).astype(np.float32)
    depth = rng.uniform(0.2, 0.8, (height, width)).astype(np.float32)
    depth[rng.uniform(size=(height, width)) < 0.25] = np.inf
    color = np.concatenate([rgb * a, a], axis=-1)
    return Framebuffer(torch.from_numpy(color).to(device),
                       torch.from_numpy(depth).to(device))


def bitmap(device, seed: int = 7, shape=(7, 5)) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (*shape, 3)).astype(np.float32)
    a = rng.uniform(0, 1, (*shape, 1)).astype(np.float32)
    return torch.from_numpy(np.concatenate([rgb * a, a], -1)).to(device)


def _color(rng):
    a = float(rng.uniform(0.3, 1.0))
    return tuple(float(np.float32(c) * np.float32(a))
                 for c in rng.uniform(0, 1, 3)) + (a,)


def verb_cases(height: int, width: int, device, seed: int = 0,
               n_random: int = 4) -> list:
    """Every verb kind: `n_random` seeded placements each, then the edge
    cases."""
    rng = np.random.default_rng(seed)
    w, h = float(width), float(height)
    bmp = bitmap(device)
    mono = fontlib.bake_builtin_font(12, "mono", device=device)
    sans = fontlib.bake_builtin_font(16, "sans", device=device)
    cases = []

    def add(name, make):
        cases.append(VerbCase(name, make))

    def xy():
        return (float(rng.uniform(-0.2, 1.2) * w),
                float(rng.uniform(-0.2, 1.2) * h))

    def transform():
        return draw2d.transform2d(
            rotation=float(rng.uniform(-math.pi, math.pi)),
            scale=tuple(float(s) for s in rng.uniform(0.3, 3.0, 2)),
            anchor=tuple(float(a) for a in rng.uniform(0, 1, 2)),
            device=device)

    for i in range(n_random):
        p, q = xy(), xy()
        mn = (min(p[0], q[0]), min(p[1], q[1]))
        mx = (max(p[0], q[0]), max(p[1], q[1]))
        c = _color(rng)
        add(f"rect {i}", lambda fb, mn=mn, mx=mx, c=c:
            draw2d.rect_verb(fb, mn, mx, c))
        t = transform()
        size = rng.uniform(0, 0.3, 2) * (w, h)
        mx2 = (mn[0] + float(size[0]), mn[1] + float(size[1]))
        add(f"rect transformed {i}", lambda fb, mn=mn, mx=mx2, c=c, t=t:
            draw2d.rect_verb(fb, mn, mx, c, t))
        add(f"line {i}", lambda fb, p=p, q=q, c=c:
            draw2d.line_verb(fb, p, q, c))
        r = float(rng.uniform(0, 0.3) * min(w, h))
        th = float(rng.uniform(0.5, 4.0))
        add(f"circle {i}", lambda fb, p=p, r=r, c=c:
            draw2d.circle_verb(fb, p, r, c, None))
        add(f"circle outline {i}", lambda fb, p=p, r=r, c=c, th=th:
            draw2d.circle_verb(fb, p, r, c, th))
        mode = ("nearest", "bilinear")[i % 2]
        tint = _color(rng)
        add(f"blit {mode} {i}", lambda fb, p=p, t=t, mode=mode, tint=tint:
            draw2d.blit_verb(fb, bmp, p, t, mode, tint))
        add(f"blit untransformed {i}", lambda fb, p=p, mode=mode:
            draw2d.blit_verb(fb, bmp, p, None, mode))
        s = "".join(chr(int(k)) for k in rng.integers(32, 127, 12))
        for font, fam in ((mono, "mono"), (sans, "sans")):
            for scale in (1, 2):
                for prop in (False, True):
                    add(f"text {fam} scale {scale} "
                        f"{'proportional' if prop else 'grid'} {i}",
                        lambda fb, font=font, s=s, p=p, c=c, scale=scale,
                        prop=prop: text.text_verb(
                            fb, font, fontlib.encode_text(s), p, c, scale,
                            prop))

    c = (0.2, 0.4, 0.6, 0.8)
    t = draw2d.transform2d(rotation=0.7, scale=(2.0, 0.5), device=device)
    edge = {
        "rect wholly off the frame": lambda fb: draw2d.rect_verb(
            fb, (-50, -40), (-10, -5), c),
        "rect partly off the frame": lambda fb: draw2d.rect_verb(
            fb, (w - 7.5, -3.25), (w + 40, 9.5), c),
        "rect zero size": lambda fb: draw2d.rect_verb(
            fb, (10, 10), (10, 20), c),
        "rect covering the frame": lambda fb: draw2d.rect_verb(
            fb, (-1, -1), (w + 1, h + 1), c),
        "rect transformed off the frame": lambda fb: draw2d.rect_verb(
            fb, (w + 60, 5), (w + 90, 30), c, t),
        "rect transformed zero size": lambda fb: draw2d.rect_verb(
            fb, (20, 20), (20, 20), c, t),
        "rect transformed scale 0": lambda fb: draw2d.rect_verb(
            fb, (5, 5), (25, 15), c, draw2d.transform2d(
                rotation=0.3, scale=0.0, device=device)),
        "rect nan": lambda fb: draw2d.rect_verb(
            fb, (float("nan"), 3), (20, 12), c),
        "rect inf": lambda fb: draw2d.rect_verb(
            fb, (-float("inf"), 3), (20, 12), c),
        "rect 2^23": lambda fb: draw2d.rect_verb(fb, (3, 4), (BIG, 12), c),
        "rect transformed inf scale": lambda fb: draw2d.rect_verb(
            fb, (5, 5), (25, 15), c, draw2d.transform2d(
                scale=float("inf"), device=device)),
        "rect transformed huge scale": lambda fb: draw2d.rect_verb(
            fb, (5, 5), (25, 15), c, draw2d.transform2d(
                rotation=0.2, scale=1e6, device=device)),
        "line point": lambda fb: draw2d.line_verb(fb, (9.5, 7.25), (9.5, 7.25),
                                                  c),
        "line vertical": lambda fb: draw2d.line_verb(fb, (4, -10), (4, h + 9),
                                                     c),
        "line off the frame": lambda fb: draw2d.line_verb(
            fb, (-30, -20), (-5, -8), c),
        "line to inf": lambda fb: draw2d.line_verb(
            fb, (5, 6), (float("inf"), 9), c),
        "line nan": lambda fb: draw2d.line_verb(
            fb, (5, float("nan")), (20, 9), c),
        "line 2^23": lambda fb: draw2d.line_verb(fb, (5, 6), (-BIG, 9), c),
        "circle radius 0": lambda fb: draw2d.circle_verb(
            fb, (10.5, 10.5), 0.0, c, None),
        "circle negative radius": lambda fb: draw2d.circle_verb(
            fb, (12, 9), -6.5, c, None),
        "circle off the frame": lambda fb: draw2d.circle_verb(
            fb, (-40, h / 2), 20, c, None),
        "circle 2^23 radius": lambda fb: draw2d.circle_verb(
            fb, (5, 5), BIG, c, None),
        "circle outline nan centre": lambda fb: draw2d.circle_verb(
            fb, (float("nan"), 5), 4, c, 1.0),
        "circle outline inf thickness": lambda fb: draw2d.circle_verb(
            fb, (w / 2, h / 2), 5, c, float("inf")),
        "circle outline negative radius": lambda fb: draw2d.circle_verb(
            fb, (w / 2, h / 3), -7, c, 3.0),
        "blit off the frame": lambda fb: draw2d.blit_verb(
            fb, bmp, (w + 3, h + 3), None, "bilinear"),
        "blit 2^23": lambda fb: draw2d.blit_verb(
            fb, bmp, (BIG, 3), None, "nearest"),
        "blit nan rotation": lambda fb: draw2d.blit_verb(
            fb, bmp, (8, 3), draw2d.transform2d(
                rotation=float("nan"), device=device), "bilinear"),
        "text off the frame": lambda fb: text.text_verb(
            fb, mono, fontlib.encode_text("gone"), (-200, 3), c, 1, False),
        "text partly off the frame": lambda fb: text.text_verb(
            fb, sans, fontlib.encode_text("Left edge"), (-13, h - 8), c, 2,
            True),
        "text 2^23": lambda fb: text.text_verb(
            fb, mono, fontlib.encode_text("far"), (int(BIG), 3), c, 1, False),
        "text negative scale": lambda fb: text.text_verb(
            fb, mono, fontlib.encode_text("mirror"), (w / 2, h / 2), c, -1,
            False),
        "text codes outside the atlas": lambda fb: text.text_verb(
            fb, mono, np.array([65, 0, 66, 127, 300, -5, 2 ** 31 - 1, 67],
                               np.int32),
            (2, 2), c, 1, False),
        "text longer than a launch": lambda fb: text.text_verb(
            fb, mono, fontlib.encode_text("0123456789" * 30), (-3, 5), c, 1,
            False),
        "text proportional longer than a launch": lambda fb: text.text_verb(
            fb, sans, fontlib.encode_text("Wide iiii " * 30), (-700, 9), c,
            1, True),
    }
    cases += [VerbCase(name, make) for name, make in edge.items()]
    return cases


def triangle_cases(height: int, width: int, seed: int = 0,
                   n_random: int = 4) -> list:
    """api.render_triangle's corners: seeded random triangles (either
    winding, culled or not, per-corner q), then the edge cases."""
    rng = np.random.default_rng(seed)
    w, h = float(width), float(height)

    def corners(xy, z=0.5, q=(1.0, 1.0, 1.0), uv=((0, 1), (1, 1), (0, 0)),
                color=(1.0, 0.9, 0.8, 0.9)):
        rows = [[x, y, z, qq, *u, *color] for (x, y), qq, u in zip(xy, q, uv)]
        return np.asarray(rows, np.float32)

    cases = []
    for i in range(n_random):
        xy = [(float(rng.uniform(-0.2, 1.2) * w),
               float(rng.uniform(-0.2, 1.2) * h)) for _ in range(3)]
        q = tuple(float(v) for v in rng.uniform(0.2, 1.0, 3))
        z = float(rng.uniform(0.1, 0.9))
        textured = bool(i % 2)
        mode = ("nearest", "bilinear")[(i // 2) % 2]
        cases.append(TriangleCase(f"random {i}", corners(xy, z, q), textured,
                                  mode, False))
        cases.append(TriangleCase(f"random {i} culled", corners(xy, z, q),
                                  textured, mode, True))
    front = [(0.1 * w, 0.1 * h), (0.9 * w, 0.2 * h), (0.3 * w, 0.9 * h)]
    back = front[::-1]
    edge = {
        "front-facing": (corners(front), True, "bilinear", False),
        "front-facing culled": (corners(front), False, "nearest", True),
        "back-facing": (corners(back), True, "bilinear", False),
        "back-facing culled": (corners(back), True, "nearest", True),
        "per-corner q": (corners(front, q=(1.0, 0.5, 0.25)), True, "bilinear",
                         False),
        "off the frame": (corners([(-30, -30), (-5, -40), (-20, -2)]), False,
                          "nearest", False),
        "degenerate": (corners([(2, 2), (10, 10), (18, 18)]), False,
                       "nearest", False),
        "nan corner": (corners([(2, 2), (float("nan"), 10), (18, 3)]), False,
                       "nearest", False),
        "q = 0": (corners(front, q=(1.0, 0.0, 1.0)), False, "nearest", False),
        "vertex at 1e12": (corners([(2, 2), (1e12, 10), (5, h - 2)]), True,
                           "nearest", False),
        "covering the frame": (corners([(-2 * w, -h), (3 * w, -h),
                                        (w / 2, 4 * h)], z=0.3), True,
                               "bilinear", False),
        "depth nan": (corners(front, z=float("nan")), False, "nearest",
                      False),
        "depth inf": (corners(front, z=float("inf")), False, "nearest",
                      False),
    }
    cases += [TriangleCase(name, *args) for name, args in edge.items()]
    return cases

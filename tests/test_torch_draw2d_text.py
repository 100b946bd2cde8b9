"""The port's 2D layer (ops/draw2d.py, ops/text.py) against the JAX package
on the CPU, and the port-side mirrors of tests/test_draw2d_text.py.

Bars:
  * text (integer-addressed): colour bit-equal to the JAX functions, jitted
    over an opaque black background (where the blend `src + dst*(1 - a)` is
    exact however XLA:CPU contracts it) and run op by op (no contraction)
    over a random background;
  * draw2d verbs: packed u8 within +-1 of the JAX verb (jitted, so XLA:CPU
    may contract FMAs), except at pixels whose deciding quantity lies within
    REL (1e-4, relative) of its threshold. The test computes those
    quantities itself in float64 and lists every pixel that differs by more;
    each must be such a pixel, and they must be under 0.5% of the
    primitive's pixels. Depth is bit-equal to the input depth;
  * the `text_proportional` golden: within +-1 u8.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from dtrenderer_tpu.assets import font as jfont
from dtrenderer_tpu.ops import draw2d as jdraw
from dtrenderer_tpu.ops import fb as jfb
from dtrenderer_tpu.ops import text as jtext
from dtrenderer_tpu.utils.color import pack_srgb_u8 as jpack
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.assets import font as pfont
from dtrenderer_tpu_torch.debug import DebugHud
from dtrenderer_tpu_torch.ops import draw2d as pdraw
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import text as ptext
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack
from dtrenderer_tpu_torch.utils.color import rgba

CPU = torch.device("cpu")
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
H, W = 64, 96
REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _background(seed=0, h=H, w=W):
    """A non-black opaque colour plane and a depth plane with finite and
    infinite values, as numpy arrays."""
    rng = np.random.default_rng(seed)
    color = np.concatenate([rng.uniform(0, 1, (h, w, 3)),
                            np.ones((h, w, 1))], -1).astype(np.float32)
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.3] = np.inf
    return color, depth


def _both(jax_verb, port_verb, color, depth):
    """Run a verb of each package on the same framebuffer."""
    ref = jax.jit(lambda c, d: jax_verb(jfb.Framebuffer(c, d)))(
        jnp.asarray(color), jnp.asarray(depth))
    out = port_verb(pfb.Framebuffer(torch.from_numpy(color),
                                    torch.from_numpy(depth)))
    np.testing.assert_array_equal(out.depth.numpy().view(np.int32),
                                  depth.view(np.int32))
    np.testing.assert_array_equal(np.asarray(ref.depth).view(np.int32),
                                  depth.view(np.int32))
    return ref, out


def _hold(ref, out, color, near, min_pixels):
    """u8 within +-1 except at listed pixels, which must all be `near` a
    threshold and rare among the primitive's pixels."""
    ju8 = np.asarray(jpack(ref.color)).astype(int)
    pu8 = ppack(out.color).numpy().astype(int)
    bg = ppack(torch.from_numpy(color)).numpy().astype(int)
    prim = (np.abs(ju8 - bg).max(-1) > 0).sum()
    assert prim >= min_pixels, f"primitive covers only {prim} pixels"
    listed = np.argwhere(np.abs(ju8 - pu8).max(-1) > 1)
    for y, x in listed:
        assert near[y, x], f"pixel {(y, x)} differs and is on no threshold"
    assert len(listed) < 5e-3 * prim, f"{len(listed)} of {prim} pixels"


def _centres(h=H, w=W):
    return (np.arange(w)[None, :] + 0.5, np.arange(h)[:, None] + 0.5)


def _close(value, threshold, scale):
    return np.abs(value - threshold) <= REL * max(scale, 1.0)


def _local(pos, size, rot, scale, anchor, h=H, w=W):
    """float64 twin of draw2d._inv_transform_coords."""
    px, py = _centres(h, w)
    c, s = np.cos(-rot), np.sin(-rot)
    dx, dy = px - pos[0], py - pos[1]
    lx = (c * dx - s * dy) / scale[0] + anchor[0] * size[0]
    ly = (s * dx + c * dy) / scale[1] + anchor[1] * size[1]
    return lx, ly


def _near_box(lx, ly, size):
    m = float(max(size[0], size[1], np.abs(lx).max(), np.abs(ly).max()))
    return (_close(lx, 0, m) | _close(lx, size[0], m) | _close(ly, 0, m)
            | _close(ly, size[1], m))


# ------------------------------------------------------------- rectangles


RECTS = {
    "plain": ((10, 8), (50, 40), (1, 0, 0, 1.0), None),
    "plain_fractional_alpha": ((10.3, 7.7), (60.2, 41.9),
                               (0.2, 0.7, 0.9, 0.5), None),
    "rotated": ((30, 20), (70, 44), (0.9, 0.8, 0.1, 0.6),
                dict(rotation=0.6)),
    "rotated_scaled_corner_anchor": ((40, 24), (60, 40), (0.3, 0.9, 0.4, 0.8),
                                     dict(rotation=-0.35, scale=(1.5, 0.75),
                                          anchor=(0.0, 0.0))),
    "anchored_far_corner": ((50, 30), (62, 38), (0.8, 0.2, 0.7, 0.4),
                            dict(rotation=-1.1, scale=2.0,
                                 anchor=(1.0, 1.0))),
}


@pytest.mark.parametrize("name", RECTS)
def test_fill_rect_matches_jax(name):
    mn, mx, col, tkw = RECTS[name]
    col = rgba(*col)
    color, depth = _background(1)
    jt = None if tkw is None else jdraw.transform2d(**tkw)
    pt = None if tkw is None else convert.transform2d(jt, CPU)
    ref, out = _both(lambda fb: jdraw.fill_rect(fb, mn, mx, col, jt),
                     lambda fb: pdraw.fill_rect(fb, mn, mx, col, pt),
                     color, depth)
    px, py = _centres()
    if tkw is None:
        near = (_close(px, mn[0], W) | _close(px, mx[0], W)
                | _close(py, mn[1], H) | _close(py, mx[1], H))
    else:
        size = (mx[0] - mn[0], mx[1] - mn[1])
        anchor = tkw.get("anchor", (0.5, 0.5))
        scale = np.broadcast_to(tkw.get("scale", 1.0), (2,))
        pos = (mn[0] + anchor[0] * size[0], mn[1] + anchor[1] * size[1])
        lx, ly = _local(pos, size, tkw.get("rotation", 0.0), scale, anchor)
        near = _near_box(lx, ly, size)
    _hold(ref, out, color, near, 300)


def test_transform2d_constructor_matches_jax():
    jt = jdraw.transform2d(rotation=0.3, scale=2.0, anchor=(0.25, 1.0))
    pt = pdraw.transform2d(rotation=0.3, scale=2.0, anchor=(0.25, 1.0),
                           device=CPU)
    for a, b in zip(jt, pt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    pt = pdraw.transform2d(device=CPU)
    assert pt.scale.tolist() == [1.0, 1.0] and pt.anchor.tolist() == [.5, .5]


def test_rect_alpha_blend_painters_order_matches_jax():
    """Two overlapping alpha rectangles, in order, against JAX."""
    color, depth = _background(2)
    a, b = rgba(1, 0, 0, 0.7), rgba(0, 0, 1, 0.5)

    def both(lib):
        def verb(fb):
            fb = lib.fill_rect(fb, (5, 5), (40, 40), a)
            return lib.fill_rect(fb, (20, 20), (60, 44), b)
        return verb

    ref, out = _both(both(jdraw), both(pdraw), color, depth)
    _hold(ref, out, color, np.zeros((H, W), bool), 1500)
    # order matters: the other order gives another image
    swapped = pdraw.fill_rect(
        pdraw.fill_rect(pfb.Framebuffer(torch.from_numpy(color),
                                        torch.from_numpy(depth)),
                        (20, 20), (60, 44), b), (5, 5), (40, 40), a)
    assert not torch.equal(swapped.color, out.color)


# ------------------------------------------------------------------ lines


LINES = {
    "x_major": ((5, 50), (90, 12)),
    "y_major": ((70, 3), (60, 60)),
    "horizontal": ((4, 10), (80, 10)),
    "steep_reversed_fractional": ((20.6, 58.2), (31.3, 2.9)),
    "point": ((33, 21), (33, 21)),
}


@pytest.mark.parametrize("name", LINES)
def test_line_matches_jax(name):
    p0, p1 = LINES[name]
    col = rgba(1, 1, 0.3, 0.9)
    color, depth = _background(3)
    ref, out = _both(lambda fb: jdraw.line(fb, p0, p1, col),
                     lambda fb: pdraw.line(fb, p0, p1, col), color, depth)
    ix, iy = np.arange(W)[None, :] + 0.0, np.arange(H)[:, None] + 0.0
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    if abs(dx) >= abs(dy):
        maj, maj0, mnr0, dmaj, dmnr = ix, p0[0], p0[1], dx, dy
    else:
        maj, maj0, mnr0, dmaj, dmnr = iy, p0[1], p0[0], dy, dx
    v = (np.floor(mnr0) + (maj - np.floor(maj0))
         * (dmnr / (dmaj if dmaj else 1.0)) + 0.5)
    near = np.broadcast_to(_close(v, np.round(v), np.abs(v).max()), (H, W))
    _hold(ref, out, color, near, 1 if name == "point" else 50)


# ---------------------------------------------------------------- circles


@pytest.mark.parametrize("center,radius,alpha", [
    ((48.2, 30.7), 17.3, 0.7), ((32, 32), 10, 1.0), ((90, 5), 25.5, 0.5)])
def test_fill_circle_matches_jax(center, radius, alpha):
    col = rgba(0.3, 0.9, 0.4, alpha)
    color, depth = _background(4)
    ref, out = _both(lambda fb: jdraw.fill_circle(fb, center, radius, col),
                     lambda fb: pdraw.fill_circle(fb, center, radius, col),
                     color, depth)
    px, py = _centres()
    d2 = (px - center[0]) ** 2 + (py - center[1]) ** 2
    _hold(ref, out, color, _close(d2, radius ** 2, radius ** 2), 250)


@pytest.mark.parametrize("center,radius,thickness", [
    ((48, 32), 20, 1.0), ((40.5, 30.25), 12.5, 3.0)])
def test_circle_outline_matches_jax(center, radius, thickness):
    col = rgba(1, 1, 1, 0.8)
    color, depth = _background(5)
    ref, out = _both(
        lambda fb: jdraw.circle_outline(fb, center, radius, col, thickness),
        lambda fb: pdraw.circle_outline(fb, center, radius, col, thickness),
        color, depth)
    px, py = _centres()
    d = np.sqrt((px - center[0]) ** 2 + (py - center[1]) ** 2)
    near = _close(np.abs(d - radius), thickness * 0.5, radius)
    _hold(ref, out, color, near, 100)


# ------------------------------------------------------------------ blits


def _bitmap(seed=7, bh=8, bw=12):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (bh, bw, 1))
    return np.concatenate([rng.uniform(0, 1, (bh, bw, 3)) * a, a],
                          -1).astype(np.float32)


BLITS = {
    "nearest_identity": ((10, 20), None, "nearest", (1, 1, 1, 1)),
    "nearest_scale2_corner": ((8, 8), dict(scale=2.0, anchor=(0.0, 0.0)),
                              "nearest", (1, 1, 1, 1)),
    "nearest_rotated_scaled": ((48, 30), dict(rotation=0.5, scale=1.7),
                               "nearest", (1, 1, 1, 1)),
    "bilinear_plain": ((30.5, 12.25), None, "bilinear", (1, 1, 1, 1)),
    "bilinear_rotated_scaled_tint": ((50, 32), dict(rotation=-0.8, scale=3.0),
                                     "bilinear", (0.8, 0.6, 0.4, 0.8)),
}


@pytest.mark.parametrize("name", BLITS)
def test_blit_matches_jax(name):
    pos, tkw, mode, tint = BLITS[name]
    bmp = _bitmap()
    bh, bw = bmp.shape[:2]
    color, depth = _background(6)
    jt = None if tkw is None else jdraw.transform2d(**tkw)
    pt = None if tkw is None else convert.transform2d(jt, CPU)
    ref, out = _both(
        lambda fb: jdraw.blit(fb, jnp.asarray(bmp), pos, jt, mode, tint),
        lambda fb: pdraw.blit(fb, torch.from_numpy(bmp), pos, pt, mode, tint),
        color, depth)
    tkw = tkw or dict(anchor=(0.0, 0.0))
    lx, ly = _local(pos, (bw, bh), tkw.get("rotation", 0.0),
                    np.broadcast_to(tkw.get("scale", 1.0), (2,)),
                    tkw.get("anchor", (0.5, 0.5)))
    near = _near_box(lx, ly, (bw, bh))
    if mode == "nearest":  # a texel border is a threshold too
        near |= _close(lx, np.round(lx), bw) | _close(ly, np.round(ly), bh)
    _hold(ref, out, color, near, 80)


def test_blit_unknown_sampling_mode_raises():
    fb = pfb.create(8, 8, CPU)
    with pytest.raises(ValueError, match="sampling"):
        pdraw.blit(fb, torch.ones(2, 2, 4), (0, 0), None, "trilinear")


# ------------------------------------------------------------------- text


@pytest.fixture(scope="module")
def fonts():
    """(JAX font, the port's shipped font) per family, 14 px, baked once."""
    return {fam: (jfont.bake_builtin_font(14, family=fam),
                  pfont.bake_builtin_font(14, fam, device=CPU))
            for fam in ("mono", "sans")}


TEXTS = [("Hello, HUD {42}!", (5, 7), 1), ("clipped left+top", (-7, -5), 1),
         ("Scale 2 ~|", (-9, -3), 2), ("", (4, 4), 1)]


def _text_pair(proportional):
    return ((jtext.draw_text_proportional, ptext.draw_text_proportional)
            if proportional else (jtext.draw_text, ptext.draw_text))


def _assert_text_equal(out, ref_color, color, depth):
    np.testing.assert_array_equal(out.color.numpy().view(np.int32),
                                  np.asarray(ref_color).view(np.int32))
    np.testing.assert_array_equal(out.depth.numpy().view(np.int32),
                                  depth.view(np.int32))
    assert (out.color.numpy() != color).any(axis=-1).sum() > 40


@pytest.mark.parametrize("proportional", [False, True],
                         ids=["grid", "proportional"])
@pytest.mark.parametrize("family", ["mono", "sans"])
@pytest.mark.parametrize("s,pos,scale", TEXTS)
def test_text_bit_equal_to_jax(fonts, family, proportional, s, pos, scale):
    jf, pf = fonts[family]
    color = np.zeros((48, 160, 4), np.float32)
    color[..., 3] = 1.0
    depth = _background(8, 48, 160)[1]
    col = (1.0, 0.9, 0.6, 0.85)
    codes = pfont.encode_text(s)
    jdraw_text, pdraw_text = _text_pair(proportional)
    fb_p = pfb.Framebuffer(torch.from_numpy(color), torch.from_numpy(depth))
    out = pdraw_text(fb_p, pf, codes, pos, col, scale)
    if not s:  # n == 0: the framebuffer itself comes back
        assert out is fb_p
        return
    ref = jax.jit(lambda c, d, k: jdraw_text(jfb.Framebuffer(c, d), jf, k,
                                             pos, col, scale).color)(
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(codes))
    _assert_text_equal(out, ref, color, depth)


@pytest.mark.parametrize("proportional", [False, True],
                         ids=["grid", "proportional"])
def test_text_over_a_background_bit_equal_to_jax_op_by_op(fonts,
                                                          proportional):
    """Translucent text over a random background: the blend rounds, so the
    JAX function runs op by op here (a jitted frame may fuse the blend's
    multiply and add)."""
    jf, pf = fonts["sans"]
    color, depth = _background(8, 48, 160)
    col = (1.0, 0.9, 0.6, 0.85)
    codes = pfont.encode_text("clipped left+top")
    jdraw_text, pdraw_text = _text_pair(proportional)
    out = pdraw_text(pfb.Framebuffer(torch.from_numpy(color),
                                     torch.from_numpy(depth)), pf, codes,
                     (-7, -5), col, 2)
    ref = jdraw_text(jfb.Framebuffer(jnp.asarray(color), jnp.asarray(depth)),
                     jf, jnp.asarray(codes), (-7, -5), col, 2)
    _assert_text_equal(out, ref.color, color, depth)


def test_text_without_advances_falls_back_to_the_grid(fonts):
    _, pf = fonts["sans"]
    bare = pf._replace(advances=None)
    fb = pfb.clear(pfb.create(32, 120, CPU), (0, 0, 0, 1))
    codes = pfont.encode_text("iiWW")
    a = ptext.draw_text_proportional(fb, bare, codes, (2, 2))
    b = ptext.draw_text(fb, pf, codes, (2, 2))
    assert torch.equal(a.color, b.color)
    assert ptext.text_width(bare, codes) == 4 * pf.cell_w


def test_text_width_matches_jax(fonts):
    for fam in ("mono", "sans"):
        jf, pf = fonts[fam]
        codes = pfont.encode_text("iiii WWWW .oO")
        assert ptext.text_width(pf, codes) == jtext.text_width(jf, codes)
        assert ptext.text_width(pf, codes, 3) == jtext.text_width(jf, codes, 3)
        assert ptext.text_width(pf, 7, 2) == jtext.text_width(jf, 7, 2)


def test_text_proportional_golden_through_the_port():
    """tests/test_goldens.py::_render_text_prop on the port."""
    sans = pfont.bake_builtin_font(16, "sans", device=CPU)
    fb = pfb.clear(pfb.create(72, 256, CPU), [0.05, 0.05, 0.1, 1.0])
    codes = pfont.encode_text("iiii WWWW .oO")
    fb = ptext.draw_text(fb, sans, codes, (4, 4), (1, 1, 1, 1))
    fb = ptext.draw_text_proportional(fb, sans, codes, (4, 30),
                                      (1, 1, 0.7, 1))
    want = np.asarray(Image.open(os.path.join(
        GOLDEN_DIR, "text_proportional.png")), np.uint8)
    diff = np.abs(ppack(fb.color).numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1, f"{(diff > 1).sum()} channels > 1"


# ------------------------- mirrors of tests/test_draw2d_text.py on the port


def _fb(h=48, w=64, clear=(0, 0, 0, 1)):
    return pfb.clear(pfb.create(h, w, CPU), clear)


def test_fill_rect_axis_aligned():
    c = pdraw.fill_rect(_fb(), (10, 8), (30, 20), rgba(1, 0, 0, 1)).color
    c = c.numpy()
    assert np.allclose(c[8:20, 10:30, 0], 1.0)
    assert np.allclose(c[8:20, 10:30, 1], 0.0)
    assert np.allclose(c[:8, :, 0], 0.0)
    assert np.allclose(c[20:, :, 0], 0.0)
    assert np.allclose(c[8:20, :10, 0], 0.0)


def test_rect_alpha_blend_painters_order():
    fb = _fb()
    fb = pdraw.fill_rect(fb, (5, 5), (40, 40), rgba(1, 0, 0, 1))
    fb = pdraw.fill_rect(fb, (20, 20), (60, 44), rgba(0, 0, 1, 0.5))
    c = fb.color.numpy()
    assert np.allclose(c[30, 30], [0.5, 0.0, 0.5, 1.0], atol=1e-6)
    assert np.allclose(c[10, 10], [1.0, 0.0, 0.0, 1.0], atol=1e-6)
    assert np.allclose(c[42, 50], [0.0, 0.0, 0.5, 1.0], atol=1e-6)


def test_rect_rotation_90deg():
    t = pdraw.transform2d(rotation=np.pi / 2, anchor=(0.5, 0.5), device=CPU)
    fb = pdraw.fill_rect(_fb(64, 64), (22, 28), (42, 36), rgba(0, 1, 0, 1), t)
    ys, xs = np.nonzero(fb.color.numpy()[..., 1] > 0.5)
    hgt = ys.max() - ys.min() + 1
    wid = xs.max() - xs.min() + 1
    assert hgt > wid, f"rotation failed: h={hgt} w={wid}"
    assert abs(hgt - 20) <= 2 and abs(wid - 8) <= 2


def test_line_dda_horizontal_vertical_diag():
    c = pdraw.line(_fb(), (5, 10), (40, 10), rgba(1, 1, 1, 1)).color.numpy()
    assert (c[10, 5:40, 0] > 0.9).all()
    assert c[11, 20, 0] == 0 and c[9, 20, 0] == 0
    c = pdraw.line(_fb(), (12, 4), (12, 30), rgba(1, 1, 1, 1)).color.numpy()
    assert (c[4:30, 12, 0] > 0.9).all()
    c = pdraw.line(_fb(), (0, 0), (32, 32), rgba(1, 1, 1, 1)).color.numpy()
    assert (np.diagonal(c[..., 0])[:32] > 0.9).all()


def test_circle_filled():
    c = pdraw.fill_circle(_fb(64, 64), (32, 32), 10,
                          rgba(1, 1, 0, 1)).color.numpy()
    assert c[32, 32, 0] > 0.9
    assert c[32, 41, 0] > 0.9  # pixel centre 41.5 -> dist 9.5 < 10
    assert c[32, 44, 0] == 0
    assert abs((c[..., 0] > 0.5).sum() - np.pi * 100) < 40


def test_blit_nearest_identity():
    bmp = np.zeros((8, 8, 4), np.float32)
    bmp[:, :, 3] = 1.0
    bmp[2, 3] = [1, 0, 0, 1]
    c = pdraw.blit(_fb(), torch.from_numpy(bmp), (10, 20)).color.numpy()
    assert np.allclose(c[22, 13], [1, 0, 0, 1]), c[20:28, 10:18, 0]
    assert np.allclose(c[22, 30], [0, 0, 0, 1])  # outside the blit untouched


def test_blit_scale2x():
    bmp = np.zeros((4, 4, 4), np.float32)
    bmp[:, :, 3] = 1.0
    bmp[0, 0] = [0, 1, 0, 1]
    t = pdraw.transform2d(scale=2.0, anchor=(0.0, 0.0), device=CPU)
    c = pdraw.blit(_fb(), torch.from_numpy(bmp), (8, 8), t).color.numpy()
    assert (c[8:10, 8:10, 1] > 0.9).all()  # a texel covers a 2x2 block
    assert c[8, 11, 1] == 0


def test_text_renders_visible_glyphs():
    font = pfont.bake_builtin_font(12, device=CPU)
    c = ptext.draw_text(_fb(48, 128), font, pfont.encode_text("Hi !"), (4, 4),
                        (1.0, 1.0, 1.0, 1.0)).color.numpy()
    assert (c[..., 0] > 0.5).sum() > 20, "no glyph coverage rendered"
    x0 = 4 + 2 * font.cell_w  # the space column is empty
    assert (c[4:4 + font.cell_h, x0:x0 + font.cell_w, 0] > 0.5).sum() == 0


def test_text_dynamic_codes():
    """HUD text changes from frame to frame: codes are data (a numpy array
    or a tensor), and other codes give other pixels."""
    font = pfont.bake_builtin_font(12, device=CPU)
    fb = _fb(32, 96)
    a = ptext.draw_text(fb, font, pfont.encode_text("fps 60.0"), (2, 2))
    b = ptext.draw_text(fb, font, pfont.encode_text("fps 59.9"), (2, 2))
    assert not torch.equal(a.color, b.color), "different text, same pixels"
    as_tensor = torch.from_numpy(pfont.encode_text("fps 60.0"))
    assert torch.equal(ptext.draw_text(fb, font, as_tensor, (2, 2)).color,
                       a.color)


def test_text_proportional_renders_and_differs():
    font = pfont.bake_builtin_font(12, device=CPU)
    codes = pfont.encode_text("iiiWWW")
    c = ptext.draw_text_proportional(_fb(48, 200), font, codes, (4, 4),
                                     (1, 1, 1, 1)).color.numpy()
    assert (c[..., 0] > 0.5).sum() > 20
    adv = font.advances.numpy()
    wi, ww = adv[ord("i") - 32], adv[ord("W") - 32]
    assert abs(ptext.text_width(font, codes) - (3 * wi + 3 * ww)) < 1e-3
    assert ptext.text_width(font, codes) > 0


def test_text_proportional_sans_family_truly_proportional():
    font = pfont.bake_builtin_font(14, family="sans", device=CPU)
    adv = font.advances.numpy()
    assert adv[ord("i") - 32] < adv[ord("W") - 32], "sans must be proportional"
    codes_i = pfont.encode_text("iiii")
    codes_w = pfont.encode_text("WWWW")
    assert ptext.text_width(font, codes_i) < ptext.text_width(font, codes_w)
    assert ptext.text_width(font, codes_i) < 4 * font.cell_w

    def lit_cols(fb):
        cols = np.where((fb.color.numpy()[..., 0] > 0.3).any(axis=0))[0]
        return (int(cols.min()), int(cols.max())) if len(cols) else (0, 0)

    white = (1, 1, 1, 1)
    pi = lit_cols(ptext.draw_text_proportional(_fb(32, 160), font, codes_i,
                                               (2, 2), white))
    pw = lit_cols(ptext.draw_text_proportional(_fb(32, 160), font, codes_w,
                                               (2, 2), white))
    mi = lit_cols(ptext.draw_text(_fb(32, 160), font, codes_i, (2, 2), white))
    assert pi[1] < pw[1], "iiii must end left of WWWW proportionally"
    assert pi[1] < mi[1], "proportional iiii must end left of monospace iiii"


def test_hud_proportional_mode_renders():
    font = pfont.bake_builtin_font(14, family="sans", device=CPU)
    hud_p = DebugHud(font, proportional=True)
    hud_m = DebugHud(font, proportional=False)
    hud_p.push_text("iiiiiiiiiiii proportional")
    hud_m.push_text("iiiiiiiiiiii proportional")
    a = hud_p.render(_fb(64, 256))
    b = hud_m.render(_fb(64, 256))
    assert not torch.equal(a.color, b.color)

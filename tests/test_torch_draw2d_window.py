"""The 2D verbs, text and api.render_triangle on their windows
(ops/draw2d.py, ops/text.py) against the full-frame computation.

Bars, on the CPU (the windows' plain torch path, D2's twin):
  * every verb of models/draw2d_cases.py (each kind at seeded random
    positions and sizes, rotated and scaled transforms, windows partly and
    wholly off the frame, zero-size shapes, non-finite values and values of
    2^22 pixels and more, monospace and proportional text at scale 1 and 2)
    through its public function equals draw_plain over the whole frame
    (Window.full): colour and depth bit for bit, NaN at the same places;
  * a window holds every pixel its verb changes, and a whole-frame window
    comes only from a non-finite or far value;
  * render_triangle (front- and back-facing, culled, per-corner q, the edge
    cases) equals the full-frame path it replaced: the setup on the tensor
    (geometry.triangle_setup_from_corners), rasterize_ref over the whole
    frame and shade_deferred; setup_host equals that setup bit for bit;
  * no verb writes the framebuffer it is given;
  * a Transform2D built by hand from tensors draws what transform2d()'s
    draws, and one whose tensors were edited in place is read again, also
    an inference tensor (which keeps no version counter); so are a font's
    advances;
  * the verbs launch nothing on the CPU, and another device raises.
"""

import math

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch import api
from dtrenderer_tpu_torch.models import draw2d_cases as cases
from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.ops import draw2d, geometry, pipeline, text
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
from dtrenderer_tpu_torch.ops.shading import make_light

CPU = torch.device("cpu")
H, W = 40, 72
VERBS = {c.name: c for c in cases.verb_cases(H, W, CPU)}
TRIANGLES = {c.name: c for c in cases.triangle_cases(H, W)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_fb(got, want):
    """Colour and depth bit-equal; a NaN may be any NaN, at the same
    places."""
    for name in ("color", "depth"):
        g, r = getattr(got, name), getattr(want, name)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(g), nan), name
        assert torch.equal(torch.where(nan, 0, g.view(torch.int32)),
                           torch.where(nan, 0, r.view(torch.int32))), name


def _public(fb, verb):
    """The verb through draw2d.draw, as its public function calls it."""
    return draw2d.draw(fb, verb)


def _changed(a, b):
    """Pixels whose colour bits differ (NaN = NaN)."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    return ~same.all(dim=-1)


@pytest.mark.parametrize("name", sorted(VERBS))
def test_verb_on_its_window_equals_the_full_frame(name):
    fb = cases.framebuffer(H, W, CPU, seed=3)
    before = [t.clone() for t in fb]
    verb = VERBS[name].make(fb)
    got = _public(fb, verb)
    full = draw2d.draw_plain(fb, verb._replace(window=draw2d.Window.full(H, W)))
    assert_same_fb(got, full)
    for a, b in zip(before, fb):  # the input planes keep their bits
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # every changed pixel lies in the window
    win = verb.window
    changed = _changed(full.color, fb.color)
    inside = torch.zeros_like(changed)
    inside[win.y0:win.y1, win.x0:win.x1] = True
    assert not (changed & ~inside).any()


def test_the_cases_draw_and_some_windows_are_small():
    """Most cases change pixels; the random placements get windows smaller
    than the frame, and only far or non-finite values the whole frame."""
    fb = cases.framebuffer(H, W, CPU, seed=3)
    drew, small = 0, 0
    for name, case in VERBS.items():
        verb = case.make(fb)
        drew += bool(_changed(_public(fb, verb).color, fb.color).any())
        win = verb.window
        if win == draw2d.Window.full(H, W):
            assert any(k in name for k in (
                "nan", "inf", "2^23", "covering", "huge", "negative scale")), \
                name
        elif not win.empty:
            small += 1
    assert drew >= 0.6 * len(VERBS) and small >= 0.5 * len(VERBS)


@pytest.mark.parametrize("xs,ys,want", [
    ((3.5, 10.25), (7.0, 9.5), (2, 16, 0, 17)),
    ((-9.0, -1.0), (0.0, 20.0), (0, 20, 0, 5)),
    ((300.0, 301.0), (2.0, 3.0), (0, 9, 295, 64)),
])
def test_box_window_pads_and_clamps(xs, ys, want):
    """WINDOW_PAD + 1 pixels (the rounding margin of a 64-wide frame)
    around the floor and ceiling of the box, clamped; x1 and y1 exclusive."""
    win = draw2d.box_window(20, 64, xs, ys)
    assert tuple(win) == want
    assert win.empty == (want[2] >= want[3])


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 2.0 ** 22,
                                 -2.0 ** 22])
def test_box_window_is_the_frame_for_far_or_nonfinite_values(bad):
    assert draw2d.box_window(20, 64, (1.0, 5.0), (2.0, 3.0), bad) == \
        draw2d.Window.full(20, 64)
    assert draw2d.box_window(20, 64, (1.0, bad), (2.0, 3.0)) == \
        draw2d.Window.full(20, 64)


# ---------------------------------------------------------- render_triangle


def _triangle_full_frame(fb, corners, texture, sampling_mode, cull):
    """api.render_triangle before windows: the setup on a tensor, the whole
    frame rasterized, the deferred pass."""
    h, w = fb.depth.shape
    k = torch.from_numpy(corners)
    c = k[:, 0:4]
    setup = geometry.triangle_setup_from_corners(c[0:1], c[1:2], c[2:3], w, h,
                                                 cull)
    z, tri = rasterize_ref(setup.coef, setup.valid, h, w)
    q = c[:, 3:4]
    attrs = torch.cat([q, k[:, 4:6] * q, k[:, 6:10] * q,
                       torch.zeros((3, 3))], dim=-1)[None]
    tex = texture if texture is not None else torch.ones((1, 1, 4))
    return pipeline.shade_deferred(fb, z, tri, setup.coef, attrs, tex,
                                   sampling_mode, "none", make_light(device=CPU))


def _texture():
    return primitives.checkerboard(16, 4, (1.0, 0.85, 0.3, 1.0),
                                   (0.15, 0.15, 0.5, 1.0), device=CPU)


@pytest.mark.parametrize("name", sorted(TRIANGLES))
def test_render_triangle_on_its_window_equals_the_full_frame(name):
    case = TRIANGLES[name]
    fb = cases.framebuffer(H, W, CPU, seed=5)
    before = [t.clone() for t in fb]
    tex = _texture() if case.textured else None
    got = draw2d.triangle(fb, case.corners, tex, case.sampling,
                          case.cull_backfaces)
    want = _triangle_full_frame(fb, case.corners, tex, case.sampling,
                                case.cull_backfaces)
    assert_same_fb(got, want)
    for a, b in zip(before, fb):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_render_triangle_through_the_api_equals_draw2d_triangle():
    case = TRIANGLES["per-corner q"]
    st = api.RenderState(cases.framebuffer(H, W, CPU, seed=5))
    rows = case.corners
    got = api.render_triangle(st, *(tuple(r[:4]) for r in rows),
                              color=tuple(rows[0, 6:10]),
                              uv0=tuple(rows[0, 4:6]), uv1=tuple(rows[1, 4:6]),
                              uv2=tuple(rows[2, 4:6]), texture=_texture(),
                              sampling_mode="bilinear")
    want = draw2d.triangle(st.fb, rows, _texture(), "bilinear", False)
    assert_same_fb(got.fb, want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cull", [False, True])
def test_setup_host_equals_the_tensor_setup(seed, cull):
    """setup_host on seeded corners, with the edge values mixed in, against
    geometry.triangle_setup_from_corners row by row."""
    rng = np.random.default_rng(seed)
    n = 64
    p = np.stack([rng.uniform(-40, 120, (n, 3)), rng.uniform(-40, 80, (n, 3)),
                  rng.uniform(0, 1, (n, 3)), rng.uniform(0, 1, (n, 3))],
                 -1).astype(np.float32)  # [n, 3 corners, 4]
    p[::7, 1, 3] = 0.0                                  # behind the eye
    p[1::9, 2, 0] = np.nan
    p[2::9, 0, 1] = np.inf
    p[3::9, 1, 0] = 1e12
    p[4::9, :, 1] = p[4::9, :1, 1]                      # flat: area2 = 0
    p[5::9, 1, :2] = p[5::9, 0, :2]                     # a repeated corner
    p[6::9, :, :2] = np.round(p[6::9, :, :2])           # integer edges
    t = torch.from_numpy(p)
    want = geometry.triangle_setup_from_corners(t[:, 0], t[:, 1], t[:, 2], W,
                                                H, cull)
    for i in range(n):
        coef, bbox, valid = draw2d.setup_host(p[i], W, H, cull)
        np.testing.assert_array_equal(coef.view(np.int32)[
            ~np.isnan(coef)], want.coef[i].numpy().view(np.int32)[
            ~np.isnan(coef)])
        assert np.array_equal(np.isnan(coef), want.coef[i].isnan().numpy())
        assert bbox == want.bbox[i].tolist()
        assert valid == bool(want.valid[i])


# ------------------------------------------------------------ Transform2D


def test_a_transform_from_tensors_draws_as_transform2d():
    kept = draw2d.transform2d(rotation=0.4, scale=(1.5, 0.75),
                              anchor=(0.2, 0.9), device=CPU)
    assert getattr(kept, "host", None) is not None
    by_hand = draw2d.Transform2D(torch.tensor(0.4), torch.tensor([1.5, 0.75]),
                                 torch.tensor([0.2, 0.9]))
    fb = cases.framebuffer(H, W, CPU, seed=1)
    a = draw2d.fill_rect(fb, (10, 5), (40, 25), (0.3, 0.2, 0.1, 0.5), kept)
    b = draw2d.fill_rect(fb, (10, 5), (40, 25), (0.3, 0.2, 0.1, 0.5), by_hand)
    assert_same_fb(a, b)
    bmp = cases.bitmap(CPU)
    assert_same_fb(draw2d.blit(fb, bmp, (20, 12), kept, "bilinear"),
                   draw2d.blit(fb, bmp, (20, 12), by_hand, "bilinear"))


def test_a_transform_edited_in_place_is_read_again():
    t = draw2d.transform2d(rotation=0.4, device=CPU)
    fb = cases.framebuffer(H, W, CPU, seed=1)
    t.rotation.fill_(1.1)
    want = draw2d.fill_rect(fb, (10, 5), (40, 25), (0.3, 0.2, 0.1, 0.5),
                            draw2d.transform2d(rotation=1.1, device=CPU))
    assert_same_fb(draw2d.fill_rect(fb, (10, 5), (40, 25),
                                    (0.3, 0.2, 0.1, 0.5), t), want)


def test_a_transform_made_under_inference_mode_is_read_again():
    fb = cases.framebuffer(H, W, CPU, seed=1)
    want = draw2d.fill_rect(fb, (10, 5), (40, 25), (0.3, 0.2, 0.1, 0.5),
                            draw2d.transform2d(rotation=1.1, device=CPU))
    with torch.inference_mode():
        t = draw2d.transform2d(rotation=0.4, device=CPU)
        t.rotation.fill_(1.1)
        got = draw2d.fill_rect(fb, (10, 5), (40, 25), (0.3, 0.2, 0.1, 0.5),
                               t)
    assert_same_fb(got, want)


@pytest.mark.parametrize("inference", [False, True])
def test_host_advances_follow_an_in_place_edit(inference):
    from dtrenderer_tpu_torch.assets.font import Font, host_advances

    ctx = torch.inference_mode() if inference else torch.no_grad()
    with ctx:
        font = Font(torch.zeros((8, 8)), 4, 8, torch.arange(95.0))
        np.testing.assert_array_equal(host_advances(font), np.arange(95.0))
        font.advances.mul_(2.0)
        np.testing.assert_array_equal(host_advances(font),
                                      2.0 * np.arange(95.0))


def test_transform2d_keeps_the_tensor_surface():
    t = draw2d.transform2d(rotation=0.3, scale=2.0, anchor=(0.25, 1.0),
                           device=CPU)
    assert isinstance(t, draw2d.Transform2D)
    assert t.rotation.shape == () and t.scale.tolist() == [2.0, 2.0]
    assert t.anchor.tolist() == [0.25, 1.0]
    assert math.isclose(float(t.rotation), 0.3, rel_tol=1e-7)
    # a tensor argument: the tensors alone, read when drawn
    u = draw2d.transform2d(rotation=torch.tensor(0.3), device=CPU)
    assert getattr(u, "host", None) is None


# ------------------------------------------------------------ dispatch


def test_the_verbs_launch_nothing_on_the_cpu_and_count_nothing():
    fb = cases.framebuffer(H, W, CPU, seed=2)
    before = draw2d.KERNEL_LAUNCHES
    for case in list(VERBS.values())[:12]:
        draw2d.draw(fb, case.make(fb))
    draw2d.triangle(fb, TRIANGLES["front-facing"].corners, None, "nearest",
                    False)
    assert draw2d.KERNEL_LAUNCHES == before


def test_an_empty_window_returns_the_framebuffer():
    fb = cases.framebuffer(H, W, CPU, seed=2)
    assert draw2d.fill_rect(fb, (-50, -40), (-10, -5), (1, 1, 1, 1)) is fb
    assert draw2d.triangle(fb, TRIANGLES["off the frame"].corners, None,
                           "nearest", False) is fb


def test_another_device_raises():
    fb = cases.framebuffer(8, 8, CPU, seed=2)
    meta = Framebuffer(fb.color.to("meta"), fb.depth.to("meta"))
    with pytest.raises(NotImplementedError, match="CUDA"):
        draw2d.fill_rect(meta, (1, 1), (4, 4), (1, 1, 1, 1))
    with pytest.raises(NotImplementedError, match="CUDA"):
        draw2d.triangle(meta, TRIANGLES["front-facing"].corners, None,
                        "nearest", False)


def test_text_scale_zero_raises():
    fb = cases.framebuffer(8, 8, CPU, seed=2)
    font = api.bake_builtin_font(12, device=CPU)
    with pytest.raises(ValueError, match="scale"):
        text.draw_text(fb, font, np.array([65], np.int32), (0, 0), scale=0)

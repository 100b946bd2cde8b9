"""The port's public surface (api.py, debug.DebugHud, tools/demo.py) against
the JAX package on the CPU.

Bars: covered pixels equal and packed u8 within +-1 of the JAX frame
(jitted), except at listed pixels. Every listed pixel must be one that
XLA:CPU's FMA contraction or a last-ulp matrix entry can move: a 2D
primitive's pixel whose deciding quantity lies within 1e-4 relative of its
threshold (tests/test_torch_draw2d_text.py computes those), or a 3D pixel at
a triangle's edge or a depth near-tie (test_torch_pipeline._explained); and
they must be rare. The port's three backends are bit-equal to each other.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_draw2d_text import _close, _local, _near_box
from test_torch_pipeline import Z_REL, _explained
from dtrenderer_tpu import api as japi
from dtrenderer_tpu.assets import font as jfont
from dtrenderer_tpu.debug import DebugHud as JDebugHud
from dtrenderer_tpu.models import primitives as jprim
from dtrenderer_tpu.ops import fb as jfb
from dtrenderer_tpu.ops.text import draw_text_proportional as jdraw_prop
from dtrenderer_tpu.utils import math3d as jm3
from dtrenderer_tpu.utils.color import pack_srgb_u8 as jpack
from dtrenderer_tpu.utils.color import rgba as jrgba
from dtrenderer_tpu_torch import api as papi
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.assets import font as pfont
from dtrenderer_tpu_torch.debug import DebugHud, FrameCounters
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import text as ptext
from dtrenderer_tpu_torch.tools import demo as pdemo
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack
from dtrenderer_tpu_torch.utils.color import rgba

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _reference_font_baked_outside_jit():
    """The reference's api.render_text bakes its default font through an
    lru_cache. A first call from inside a jitted frame (as below) would
    cache a tracer, and every later test of the same worker process that
    draws text through the reference would fail on the leaked tracer: bake
    it eagerly first."""
    jfont.bake_builtin_font(12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8_diff(jstate, pstate):
    return np.abs(np.asarray(jpack(jstate.fb.color)).astype(int)
                  - ppack(pstate.fb.color).numpy().astype(int)).max(-1)


def test_rgba_matches_jax():
    for args in ((0.9, 0.2, 0.2, 0.6), (1, 1, 0.3, 1), (0.06, 0.07, 0.12),
                 (0.1, 0.3, 1.0, 0.9)):
        got = np.asarray(rgba(*args), np.float32)
        assert all(isinstance(x, float) for x in rgba(*args))
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(jrgba(*args)).view(np.int32))


# --------------------- mirrors of tests/test_api_surface.py, against JAX


@pytest.mark.parametrize("q", [(1.0, 1.0, 1.0), (1.0, 0.5, 0.25)],
                         ids=["affine", "per_corner_q"])
def test_render_triangle_textured_perspective(q):
    corners = [(8, 8, 0.5, q[0]), (56, 8, 0.5, q[1]), (8, 56, 0.5, q[2])]
    kw = dict(uv0=(0, 1), uv1=(1, 1), uv2=(0, 0))
    jtex = jprim.checkerboard(16, 2, (1, 0, 0, 1), (0, 0, 1, 1))
    jst = jax.jit(lambda st: japi.render_triangle(
        japi.clear(st, jrgba(0, 0, 0, 1)), *corners, texture=jtex, **kw))(
        japi.new_state(64, 64))
    st = papi.clear(papi.new_state(64, 64, device=CPU), rgba(0, 0, 0, 1))
    st = papi.render_triangle(st, *corners,
                              texture=convert.texture(jtex, CPU), **kw)
    c = st.fb.color.numpy()
    # interior covered and textured with two distinct colors, depth written
    assert c[20, 20, 3] == 1.0
    reds = (c[..., 0] > 0.5) & (c[..., 2] < 0.5)
    blues = (c[..., 2] > 0.5) & (c[..., 0] < 0.5)
    assert reds.sum() > 50 and blues.sum() > 50, (reds.sum(), blues.sum())
    assert np.isfinite(st.fb.depth.numpy()[20, 20])
    # against JAX: the same covered pixels and depth; a texel border that the
    # interpolated uv straddles may flip under FMA contraction
    np.testing.assert_array_equal(np.isfinite(st.fb.depth.numpy()),
                                  np.isfinite(np.asarray(jst.fb.depth)))
    np.testing.assert_allclose(st.fb.depth.numpy(), np.asarray(jst.fb.depth),
                               rtol=Z_REL)
    covered = np.isfinite(st.fb.depth.numpy()).sum()
    assert covered > 1000
    assert (_u8_diff(jst, st) > 1).sum() <= 5e-3 * covered


def test_render_triangle_flat_color_depth_test():
    def frame(api, st, col):
        st = api.clear(st, col(0, 0, 0, 1))
        st = api.render_triangle(st, (2, 2, 0.5), (30, 2, 0.5), (2, 30, 0.5),
                                 color=col(0, 1, 0, 1))
        # a farther triangle must lose the z-test
        return api.render_triangle(st, (2, 2, 0.9), (30, 2, 0.9), (2, 30, 0.9),
                                   color=col(1, 0, 0, 1))

    jst = jax.jit(lambda st: frame(japi, st, jrgba))(japi.new_state(32, 32))
    st = frame(papi, papi.new_state(32, 32, device=CPU), rgba)
    c = st.fb.color.numpy()
    assert c[10, 10, 1] > 0.9 and c[10, 10, 0] < 0.1
    np.testing.assert_array_equal(st.fb.depth.numpy(),
                                  np.asarray(jst.fb.depth))
    assert _u8_diff(jst, st).max() <= 1


def test_full_frame_through_api():
    jmesh = jprim.cube()
    jproj = jnp.asarray(jm3.perspective(np.pi / 3, 128 / 96, 0.1, 50.0))
    jm_a, jm_b = jm3.model_matrix((0, 0, -4)), jm3.model_matrix((-1.2, 0, -4))
    jtex = jprim.checkerboard(8, 2)

    def frame(api, st, col, mesh, m_a, m_b, proj, tex):
        st = api.clear(st, col(0.1, 0.1, 0.2, 1))
        st = api.render_mesh(st, mesh, m_a, proj, texture=tex)
        st = api.render_mesh_ordered(st, mesh, m_b, proj,
                                     color=col(0.9, 0.4, 0.2, 0.5),
                                     shading="none")
        st = api.render_rectangle(st, (4, 4), (30, 16), col(1, 0, 0, 0.5))
        st = api.render_line(st, (0, 90), (127, 70), col(1, 1, 0, 1))
        return api.render_text(st, "ok", (40, 4))

    jst = jax.jit(lambda st: frame(japi, st, jrgba, jmesh, jm_a, jm_b, jproj,
                                   jtex))(japi.new_state(128, 96))
    st = frame(papi, papi.new_state(128, 96, device=CPU), rgba,
               convert.mesh(jmesh, CPU), convert.matrix(jm_a, CPU),
               convert.matrix(jm_b, CPU), convert.matrix(jproj, CPU),
               convert.texture(jtex, CPU))
    img = papi.finish_frame(st)
    assert img.shape == (96, 128, 4) and img.dtype == torch.uint8
    img = img.numpy()
    assert img[..., 3].min() == 255  # opaque frame
    assert len(np.unique(img[..., 0])) > 5  # actual content variety
    np.testing.assert_array_equal(img, ppack(st.fb.color).numpy())
    # against JAX: the same covered pixels. The two cubes' front faces are
    # coplanar (both at z = -3), so where they overlap the translucent
    # cube's strict depth test is a tie that FMA noise decides; every pixel
    # that differs must lie in that overlap.
    zj, zp = np.asarray(jst.fb.depth), st.fb.depth.numpy()
    np.testing.assert_array_equal(np.isfinite(zp), np.isfinite(zj))
    assert np.isfinite(zj).sum() > 1500
    empty = papi.new_state(128, 96, device=CPU)
    z_a = papi.render_mesh(empty, convert.mesh(jmesh, CPU),
                           convert.matrix(jm_a, CPU),
                           convert.matrix(jproj, CPU)).fb.depth.numpy()
    z_b = papi.render_mesh(empty, convert.mesh(jmesh, CPU),
                           convert.matrix(jm_b, CPU),
                           convert.matrix(jproj, CPU)).fb.depth.numpy()
    tie = np.isfinite(z_a) & np.isfinite(z_b) & np.isclose(z_a, z_b,
                                                           rtol=Z_REL)
    off = _u8_diff(jst, st) > 1
    assert 0 < tie.sum() < 0.3 * np.isfinite(zj).sum()
    assert not (off & ~tie).any(), np.argwhere(off & ~tie)


@pytest.mark.parametrize("verb", ["render_mesh", "render_meshes",
                                  "render_mesh_ordered"])
def test_mesh_verbs_return_counters(verb):
    st = papi.new_state(64, 48, device=CPU)
    cube = pprim.cube(device=CPU)
    proj = pm3.perspective(np.pi / 3, 64 / 48, 0.1, 50.0, device=CPU)
    mdl = pm3.model_matrix((0, 0, -4), pm3.rotate_y(0.5, device=CPU),
                           device=CPU)
    if verb == "render_meshes":
        call = lambda **kw: papi.render_meshes(
            st, proj, [ppipe.DrawSpec(cube, mdl)], **kw)
    else:
        call = lambda **kw: getattr(papi, verb)(st, cube, mdl, proj, **kw)
    plain = call()
    assert isinstance(plain, papi.RenderState)
    out, counters = call(return_counters=True)
    assert isinstance(out, papi.RenderState)
    assert isinstance(counters, FrameCounters)
    assert torch.equal(out.fb.color, plain.fb.color)
    # backend "ref" counts the mesh's faces, the binned paths their setup
    # rows (two per face with near clipping)
    assert int(counters.tris_submitted) == (
        cube.num_tris if verb == "render_mesh" else 2 * cube.num_tris)
    assert int(counters.pixels_shaded) == int(
        torch.isfinite(out.fb.depth).sum()) > 100
    assert int(counters.bin_overflow) == 0
    opts = "ordered_opts" if verb == "render_meshes" else "raster_opts"
    with pytest.raises(NotImplementedError, match="capacity"):
        call(**{opts: dict(capacity=64)})


def test_state_properties_and_device():
    st = papi.new_state(40, 24, device=CPU)
    assert (st.width, st.height, st.device) == (40, 24, CPU)
    assert torch.isinf(st.fb.depth).all() and not st.fb.color.any()
    st = papi.clear(st)
    assert st.fb.color[..., 3].eq(1).all()
    a = papi.render_circle(st, (20, 12), 6, rgba(1, 1, 1, 1))
    b = papi.render_circle(st, (20, 12), 6, rgba(1, 1, 1, 1), filled=False)
    assert a.fb.color[12, 20, 0] == 1 and b.fb.color[12, 20, 0] == 0
    assert b.fb.color[..., 0].sum() > 10
    bmp = pprim.checkerboard(4, 2, device=CPU)
    c = papi.render_bitmap(st, bmp, (3, 5))
    assert c.fb.color[5:9, 3:7, 0].gt(0).all() and c.fb.color[4, 3, 0] == 0
    assert papi.transform2d is not None and papi.make_light is not None


# ----------------------------------------------------------------- the HUD


def _lines_image(lines, font, h=80, w=320, proportional=False):
    from dtrenderer_tpu_torch.ops import fb as pfb

    fb = pfb.clear(pfb.create(h, w, CPU), (0, 0, 0, 1))
    draw = ptext.draw_text_proportional if proportional else ptext.draw_text
    y = 4
    for ln in lines:
        fb = draw(fb, font, pfont.encode_text(ln), (4, y), (1, 1, 1, 1), 1)
        y += font.cell_h + 2
    return fb


def test_debug_hud_lines_timing_and_overflow():
    from dtrenderer_tpu_torch.ops import fb as pfb

    blank = pfb.clear(pfb.create(80, 320, CPU), (0, 0, 0, 1))
    with pytest.raises(ValueError, match="font or a device"):
        DebugHud()
    hud = DebugHud(device=CPU)  # bakes the default 12-px mono font
    font = pfont.bake_builtin_font(12, device=CPU)
    assert torch.equal(hud.font.atlas, font.atlas)
    hud.frame_ms = 12.345
    hud.push_text("plain line")
    hud.push_text("fmt %d %s", 7, "x")
    out = hud.render(blank)
    assert hud.lines == []
    want = _lines_image(["frame:   12.35 ms", "plain line", "fmt 7 x"], font)
    assert torch.equal(out.color, want.color)
    assert torch.equal(out.depth, blank.depth)

    def counters(overflow):
        return FrameCounters(*[torch.tensor(v, dtype=torch.int32)
                               for v in (2992, 518, 5264, overflow)])

    out = hud.render(blank, counters(0))
    want = _lines_image(["frame:   12.35 ms", "tris: 518/2992  px: 5264"],
                        font)
    assert torch.equal(out.color, want.color)
    out = hud.render(blank, counters(3))
    want = _lines_image(["frame:   12.35 ms", "tris: 518/2992  px: 5264",
                         "!! bin overflow: 3 dropped (raise capacity)"], font)
    assert torch.equal(out.color, want.color)

    hud.end_frame_timing()
    first = hud.frame_ms
    assert first > 0
    hud.end_frame_timing()
    assert 0 <= hud.frame_ms < first + 1000


# ------------------------------------------ the slice as a whole: the demo


T_DEMO = 0.6
DW, DH = 160, 120


def _jax_demo_module():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_demo", os.path.join(REPO, "tools", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_demo():
    """The port's demo frame on each backend, with HUD and footer: {backend:
    (state before HUD, final state, counters)}, and the scene's pieces."""
    torch.set_num_threads(1)
    cube, sphere = pprim.cube(device=CPU), pprim.uv_sphere(24, 32, device=CPU)
    tex = pprim.checkerboard(64, 8, (1.0, 0.85, 0.3, 1.0),
                             (0.15, 0.15, 0.5, 1.0), device=CPU)
    grad = pprim.gradient_texture(64, device=CPU)
    sans = pfont.bake_builtin_font(16, "sans", device=CPU)
    frames = {}
    for backend in ("fused", "pallas", "ref"):
        st, counters = pdemo.demo_frame(
            papi.new_state(DW, DH, device=CPU), T_DEMO, cube, sphere, tex,
            grad, backend)
        frames[backend] = (st, counters)
    return frames, (cube, sphere, tex, grad, sans)


def _finish(pstate, hud_counters, sans):
    """HUD (fixed frame time, the given counters) and footer on the port."""
    hud = DebugHud(pfont.bake_builtin_font(14, device=CPU))
    hud.frame_ms = 16.67
    hud.push_text("demo  backend=test")
    st = pstate._replace(fb=hud.render(pstate.fb, hud_counters))
    return pdemo.draw_footer(st, sans)


def test_demo_backends_bit_equal(port_demo):
    frames, _ = port_demo
    fused = frames["fused"][0].fb
    assert torch.isfinite(fused.depth).sum() > 4000
    for backend in ("pallas", "ref"):
        fb = frames[backend][0].fb
        assert torch.equal(fb.color.view(torch.int32),
                           fused.color.view(torch.int32)), backend
        assert torch.equal(fb.depth.view(torch.int32),
                           fused.depth.view(torch.int32)), backend
    assert frames["pallas"][1] is None and frames["ref"][1] is None
    c = frames["fused"][1]
    assert int(c.tris_submitted) == 2 * (12 + 1472 + 12)
    assert int(c.bin_overflow) == 0


def _near_2d(t):
    """Pixels of the demo's 2D primitives whose deciding quantity is within
    1e-4 relative of its threshold (float64 twins, as in
    test_torch_draw2d_text.py)."""
    w, h = DW, DH
    t = float(np.float32(t))
    px, py = np.arange(w)[None, :] + 0.5, np.arange(h)[:, None] + 0.5
    near = np.zeros((h, w), bool)
    # rotated rectangle (70, h-110)-(180, h-60), rotation f32(t) * f32(0.8)
    size = (110.0, 50.0)
    lx, ly = _local((70 + 55.0, h - 110 + 25.0), size,
                    float(np.float32(t) * np.float32(0.8)), (1, 1),
                    (0.5, 0.5), h, w)
    near |= _near_box(lx, ly, size)
    # line (w-180, h-30) -> (w-30, h-100): x-major
    v = (h - 30) + (np.arange(w)[None, :] - (w - 180.0)) * (-70 / 150) + 0.5
    near |= np.broadcast_to(_close(v, np.round(v), np.abs(v).max()), (h, w))
    # circle (w-100, h-140) r 28
    d2 = (px - (w - 100)) ** 2 + (py - (h - 140)) ** 2
    near |= _close(d2, 28.0 ** 2, 28.0 ** 2)
    # blit of the 16x16 checker at (w-220, 40), rotation -t, scale 3
    lx, ly = _local((w - 220.0, 40.0), (16, 16), -t, (3, 3), (0.5, 0.5), h, w)
    near |= _near_box(lx, ly, (16, 16))
    return near


@pytest.mark.parametrize("backend", ["fused", "pallas", "ref"])
def test_demo_frame_matches_jax(port_demo, backend):
    frames, (cube, sphere, tex, grad, sans) = port_demo
    jd = _jax_demo_module()
    jcube, jsphere = jprim.cube(), jprim.uv_sphere(24, 32)
    jtex = jprim.checkerboard(64, 8, (1.0, 0.85, 0.3, 1.0),
                              (0.15, 0.15, 0.5, 1.0))
    jgrad = jprim.gradient_texture(64)
    jst, jcounters = jax.jit(lambda st, t: jd.demo_frame(
        st, t, jcube, jsphere, jtex, jgrad, backend))(
        japi.new_state(DW, DH), jnp.float32(T_DEMO))
    pst, pcounters = frames[backend]
    if backend == "fused":
        assert int(jcounters.bin_overflow) == 0
        assert int(pcounters.tris_submitted) == int(jcounters.tris_submitted)
        assert int(pcounters.tris_valid) == int(jcounters.tris_valid)

    # HUD and footer on both, with the same frame time and counters
    jhud = JDebugHud(jfont.bake_builtin_font(14))
    jhud.frame_ms = 16.67
    jhud.push_text("demo  backend=test")
    jsans = jfont.bake_builtin_font(16, family="sans")

    @jax.jit
    def jfinish(color, depth):
        fb = jhud.render(jfb.Framebuffer(color, depth), jcounters)
        return jdraw_prop(fb, jsans, jfont.encode_text(pdemo.FOOTER),
                          (8, DH - jsans.cell_h - 6), pdemo.FOOTER_COLOR)

    jfinal = japi.RenderState(jfinish(jst.fb.color, jst.fb.depth))
    hud_counters = None if jcounters is None else FrameCounters(
        *[torch.tensor(int(c), dtype=torch.int32) for c in jcounters])
    pfinal = _finish(pst, hud_counters, sans)
    # the HUD and the footer drew something, and left the depth alone
    assert not torch.equal(pfinal.fb.color[:70], pst.fb.color[:70])
    assert not torch.equal(pfinal.fb.color[-30:], pst.fb.color[-30:])
    assert torch.equal(pfinal.fb.depth, pst.fb.depth)

    zj, zp = np.asarray(jfinal.fb.depth), pfinal.fb.depth.numpy()
    z_off = (np.isfinite(zj) != np.isfinite(zp)) | (
        np.isfinite(zj) & np.isfinite(zp)
        & ~np.isclose(zp, zj, rtol=Z_REL, atol=0))
    listed = np.argwhere(z_off | (_u8_diff(jfinal, pfinal) > 1))
    near = _near_2d(T_DEMO)
    _, light, draws = pdemo.demo_draws(np.float32(T_DEMO), DW, DH, cube,
                                       sphere, tex, grad, CPU)
    proj = pm3.perspective(np.pi / 3, DW / DH, 0.1, 100.0, device=CPU)
    batch = ppipe.pack_draws(draws, proj, light, "bilinear", DW, DH)
    for y, x in listed:
        z_ref = zj[y, x] if np.isfinite(zj[y, x]) else zp[y, x]
        assert near[y, x] or _explained(batch, z_ref, y, x), (
            f"pixel {(y, x)} differs from JAX and is neither on a 2D "
            f"threshold nor at a triangle edge or depth tie")
    assert len(listed) <= 5e-3 * DW * DH, f"{len(listed)} listed pixels"

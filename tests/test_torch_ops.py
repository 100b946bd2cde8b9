"""PyTorch port vs the JAX reference: math3d, color, shading and the vertex
stage (triangle setup, near clipping, viewport).

Inputs are made with numpy from a seed and handed to both packages (the port
through dtrenderer_tpu_torch.convert). These are single elementwise programs
on both sides, so results are compared bit for bit unless a comment says why
not.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import assert_ulp
from dtrenderer_tpu.ops import geometry as jgeo
from dtrenderer_tpu.ops import shading as jshade
from dtrenderer_tpu.ops.raster_ref import rasterize_ref
from dtrenderer_tpu.utils import color as jcolor
from dtrenderer_tpu.utils import math3d as jm3
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import geometry as pgeo
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops import shading as pshade
from dtrenderer_tpu_torch.utils import color as pcolor
from dtrenderer_tpu_torch.utils import math3d as pm3

CPU = torch.device("cpu")


def T(a, dtype=np.float32):
    return convert.tensor(a, CPU, dtype)


def assert_bits(ref, got):
    """Bit-for-bit equality (f32 compared as int32 bit patterns)."""
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.astype(np.float32).view(np.int32)
    np.testing.assert_array_equal(ref, got)


# ------------------------------------------------------------------ math3d


def test_mat4mul_and_transforms_bit_exact():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(4, 4)).astype(np.float32)
    pts = rng.normal(size=(257, 4)).astype(np.float32)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    assert_bits(jm3.mat4mul(a, b), pm3.mat4mul(T(a), T(b)))
    assert_bits(jm3.transform_points(jnp.asarray(pts), jnp.asarray(a)),
                pm3.transform_points(T(pts), T(a)))
    assert_bits(jm3.transform_directions(jnp.asarray(dirs), jnp.asarray(a)),
                pm3.transform_directions(T(dirs), T(a)))
    assert_bits(jm3.homogenize(jnp.asarray(dirs)), pm3.homogenize(T(dirs)))


def test_perspective_and_model_matrix_bit_exact():
    assert_bits(jm3.perspective(np.pi / 3, 16 / 9, 0.1, 100.0),
                pm3.perspective(np.pi / 3, 16 / 9, 0.1, 100.0, device=CPU))
    rot = jm3.mat4mul(jm3.rotate_y(0.48), jm3.rotate_x(0.4))
    # same rotation bits on both sides (convert), then the composition
    assert_bits(jm3.model_matrix((1.5, -0.3, -4.6), rot, 1.3),
                pm3.model_matrix((1.5, -0.3, -4.6), convert.matrix(rot, CPU),
                                 1.3, device=CPU))


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotations_within_one_ulp(axis):
    # jnp.cos and torch.cos may round differently in the last ulp; the
    # pipeline tests take the reference's matrices through convert.py.
    for theta in (0.0, 0.3, 0.5, -0.6, 1.7, 3.0):
        ref = getattr(jm3, f"rotate_{axis}")(theta)
        got = getattr(pm3, f"rotate_{axis}")(theta, device=CPU)
        assert_ulp(ref, got.numpy(), max_ulp=1, msg=f"{axis} {theta}")


# ------------------------------------------------------------------- color


def test_color_transfer_functions():
    c = np.linspace(-0.1, 1.2, 4099).astype(np.float32)
    # The divides and the branch select are IEEE on both sides, but `**` is
    # each library's own pow, and neither XLA's nor ATen's is correctly
    # rounded: on this grid they differ by up to 2 (to linear) and 4 (to
    # sRGB) ulp. The packed u8 bar below is what the pipeline relies on.
    assert_ulp(jcolor.srgb_to_linear(c), pcolor.srgb_to_linear(T(c)).numpy(),
               max_ulp=4)
    assert_ulp(jcolor.linear_to_srgb(c), pcolor.linear_to_srgb(T(c)).numpy(),
               max_ulp=4)


def test_color_premultiply_blend_decode_pack():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 1, (33, 4)).astype(np.float32)
    dst = rng.uniform(0, 1, (33, 4)).astype(np.float32)
    assert_bits(jcolor.premultiply(src), pcolor.premultiply(T(src)))
    assert_bits(jcolor.blend_over(src, dst), pcolor.blend_over(T(src), T(dst)))
    u8 = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"),
                  -1).reshape(-1, 2)
    u8 = np.concatenate([u8, u8[:, ::-1]], 1).astype(np.uint8)  # [65536, 4]
    assert_ulp(jcolor.decode_srgb_u8(u8),  # pow, as above
               pcolor.decode_srgb_u8(torch.from_numpy(u8)).numpy(), max_ulp=4)
    lin = rng.uniform(-0.2, 1.3, (4096, 4)).astype(np.float32)
    d = np.abs(np.asarray(jcolor.pack_srgb_u8(lin)).astype(int)
               - pcolor.pack_srgb_u8(T(lin)).numpy().astype(int))
    assert d.max() <= 1


def test_framebuffer_create_clear_pack():
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu_torch.ops import fb as pfb

    rgba = [0.2, 0.5, 0.05, 0.75]
    ref = jfb.clear(jfb.create(6, 10), rgba)
    got = pfb.clear(pfb.create(6, 10, CPU), rgba)
    assert_bits(ref.color, got.color)
    assert_bits(ref.depth, got.depth)
    assert_bits(jfb.pack(ref), pfb.pack(got))
    blank = pfb.clear(got)
    assert_bits(jfb.clear(ref).color, blank.color)
    assert (got.height, got.width) == (6, 10)


# ----------------------------------------------------------------- shading


def test_shading_terms_bit_exact():
    rng = np.random.default_rng(7)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n[:5] = 0.0  # zero normals: ambient-lit, never NaN
    rgba = rng.uniform(0, 1, (500, 4)).astype(np.float32)
    jl = jshade.make_light((0.4, 0.6, 1.0), 0.15)
    pl = convert.light(jl, CPU)
    assert_bits(jshade.normalize_exact(n), pshade.normalize_exact(T(n)))
    term_j = jshade.light_term(n, jl)
    term_p = pshade.light_term(T(n), pl)
    assert_bits(term_j, term_p)
    assert_bits(jshade.apply_light(rgba, term_j),
                pshade.apply_light(T(rgba), term_p))
    assert np.all(np.isfinite(term_p.numpy()))


# -------------------------------------------------------- vertex stage


def _random_corners(rng, n, w, h):
    p = np.zeros((3, n, 4), np.float32)
    p[..., 0] = rng.uniform(-0.3 * w, 1.3 * w, (3, n))
    p[..., 1] = rng.uniform(-0.3 * h, 1.3 * h, (3, n))
    p[..., 2] = rng.uniform(0, 1, (3, n))
    p[..., 3] = rng.uniform(0.1, 2, (3, n))
    p[0, :20, 3] = 0.0                       # behind the camera
    p[1, 20:30, 0] = np.inf                  # non-finite
    p[2, 30:40] = p[0, 30:40]                # degenerate (area 0)
    p[:, 40:60, :2] = np.round(p[:, 40:60, :2])  # integer corners: E == 0
    return p


@pytest.mark.parametrize("cull", [True, False])
def test_triangle_setup_bit_exact(cull):
    rng = np.random.default_rng(11 + cull)
    w, h = 160, 120
    p = _random_corners(rng, 2000, w, h)
    ref = jgeo.triangle_setup_from_corners(*map(jnp.asarray, p), w, h, cull)
    got = pgeo.triangle_setup_from_corners(*map(T, p), w, h, cull)
    assert_bits(ref.coef, got.coef)
    assert_bits(ref.bbox, got.bbox)
    assert_bits(ref.valid, got.valid)
    assert 0 < int(got.valid.sum()) < 2000


def test_clip_near_counts_and_attrs():
    """Mirror of tests/test_clipping.py on the port."""
    a = torch.zeros((1, 3, 9))
    for w, want in (((1.0, 1.0, -0.5), [True, True]),
                    ((1.0, -1.0, -0.5), [True, False]),
                    ((-1.0, -1.0, -0.5), [False, False]),
                    ((1.0, 2.0, 0.5), [True, False])):
        c = torch.tensor([[[0, 0, 0, w[0]], [1, 0, 0, w[1]], [0, 1, 0, w[2]]]])
        c2, _, v2 = pgeo.clip_near(c, a)
        assert v2.tolist() == [want]
    assert torch.equal(c2[0, 0], c[0])  # all in front: slot 0 is the input
    eps = np.float32(pgeo.NEAR_EPS)
    c = torch.tensor([[[0, 0, 0, 1.0], [2, 0, 0, -1.0], [0, 2, 0, 1.0]]])
    a = torch.zeros((1, 3, 9))
    a[0, 1, 0] = 1.0
    c2, a2, _ = pgeo.clip_near(c, a)
    assert abs(float(c2[0, 0, 2, 3]) - eps) < 1e-6
    assert abs(float(a2[0, 0, 2, 0]) - (eps - 1.0) / -2.0) < 1e-5


def test_clip_near_and_screen_bit_exact():
    rng = np.random.default_rng(13)
    n = 3000
    c = rng.normal(size=(n, 3, 4)).astype(np.float32)
    c[..., 3] = rng.uniform(-1.0, 2.0, (n, 3))
    c[:50, :, 3] = 0.5          # fully in front
    c[50:60, 1, 3] = c[50:60, 0, 3]  # equal w on an edge (denominator 0)
    attrs = rng.normal(size=(n, 3, 9)).astype(np.float32)
    ref = jgeo.clip_near(jnp.asarray(c), jnp.asarray(attrs))
    got = pgeo.clip_near(T(c), T(attrs))
    for r, g in zip(ref, got):
        assert_bits(r, g)
    clip = np.asarray(ref[0]).reshape(-1, 3, 4)
    assert_bits(jgeo.corners_to_screen(jnp.asarray(clip), 200, 100),
                pgeo.corners_to_screen(T(clip), 200, 100))


def _port_coverage(screen, faces, h, w):
    """Per-pixel count of triangles covering each pixel, each rasterized
    alone by the port's plain twin (the kernel's arithmetic)."""
    sc = T(screen)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64)
    setup = pgeo.triangle_setup_from_corners(sc[f[:, 0]], sc[f[:, 1]],
                                             sc[f[:, 2]], w, h, False)
    lut = torch.ones((1, 4))
    light = pshade.make_light(device=CPU)
    total = np.zeros((h, w), np.int32)
    for i in range(len(faces)):
        coef, bbox, valid = (x[i:i + 1] for x in setup)
        bins = pbin.bin_triangles(coef, bbox, valid, h, w)
        payload = torch.zeros((1, prf.PAYLOAD_CHANNELS))
        payload[:, prf.P_TW:prf.P_TH + 1] = 1.0
        z, _, _ = prf.render_fused_plain(coef, payload, bins, lut, light, h, w)
        total += np.isfinite(z.numpy())
    return total, setup


def _reference_coverage(screen, faces, h, w):
    total = np.zeros((h, w), np.int32)
    for f in faces:
        setup = jgeo.triangle_setup(jnp.asarray(screen), jnp.asarray([f]), w,
                                    h, cull_backfaces=False)
        _, tri = rasterize_ref(setup.coef, setup.valid, h, w)
        total += np.asarray(tri) >= 0
    return total


def _screen(verts):
    v = np.asarray(verts, np.float32)
    out = np.zeros((v.shape[0], 4), np.float32)
    out[:, :2] = v
    out[:, 2] = 0.5
    out[:, 3] = 1.0
    return out


def _fan():
    cx, cy, n = 32.0, 24.0, 12
    angs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = [(cx + 20 * np.cos(a), cy + 18 * np.sin(a)) for a in angs]
    return [(cx, cy)] + ring, [(0, 1 + i, 1 + (i + 1) % n) for i in range(n)]


FILL_CASES = {
    "shared_edge_quad": ([(4.0, 4.0), (60.0, 4.0), (60.0, 44.0), (4.0, 44.0)],
                         [(0, 1, 2), (0, 2, 3)], 48, 64),
    "triangle_fan": (*_fan(), 48, 64),
    "integer_box": ([(8.0, 8.0), (24.0, 8.0), (24.0, 16.0), (8.0, 16.0)],
                    [(0, 1, 2), (0, 2, 3)], 32, 32),
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_rule_shared_edges(case):
    """Mirror of tests/test_fill_rule.py: shared edges paint every pixel
    exactly once, with the same coverage as the reference rasterizer."""
    verts, faces, h, w = FILL_CASES[case]
    screen = _screen(verts)
    total, _ = _port_coverage(screen, faces, h, w)
    assert total.max() == 1, "double-covered pixels on a shared edge"
    np.testing.assert_array_equal(total,
                                  _reference_coverage(screen, faces, h, w))
    if case == "integer_box":
        ys, xs = np.nonzero(total)
        assert (ys.min(), ys.max(), xs.min(), xs.max()) == (8, 15, 8, 23)
        assert total.sum() == 16 * 8


# ------------------------------------------------------------------ assets

OBJ_TEXT = """# quad + triangle, mixed corner forms, negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4//1
f -4 -3 -1
"""


def test_obj_text_and_file_loaders_match_reference():
    from dtrenderer_tpu.assets import obj as jobj
    from dtrenderer_tpu.models.scenes import _head_mesh
    from dtrenderer_tpu_torch.assets import obj as pobj
    from dtrenderer_tpu_torch.models.scenes import head_mesh

    for ref, got in ((jobj.load_obj_text(OBJ_TEXT),
                      pobj.load_obj_text(OBJ_TEXT, device=CPU)),
                     (_head_mesh(), head_mesh(CPU))):
        for name in ("verts", "uv", "normals"):
            assert_bits(getattr(ref, name), getattr(got, name))
        np.testing.assert_array_equal(np.asarray(ref.faces),
                                      got.faces.numpy())
    assert got.num_tris > 1000  # head.obj, normals computed by np.add.at


def test_head_texture_matches_reference():
    from dtrenderer_tpu.models.scenes import _head_texture
    from dtrenderer_tpu_torch.models.scenes import head_texture

    assert_ulp(_head_texture(), head_texture(CPU).numpy(), max_ulp=4)  # pow

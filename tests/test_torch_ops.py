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


# ---------------------------- math3d vectors and cameras, the mesh setup


def test_vector_helpers_bit_exact():
    """dot, length, normalize, lerp on [N, 3] and [N, 4] vectors: jnp.sum
    over 3 or 4 elements adds left to right and jnp.sqrt is correctly
    rounded, so each is bit for bit. jnp.cross is a jitted program in which
    XLA:CPU contracts a1*b2 - a2*b1 to one FMA; the port keeps FORMULAS.md's
    two roundings (flat shading's face normal is held bit-equal to the NumPy
    oracle with it), so cross is bit-equal to that formula in numpy and
    within the roundings of the two products of jnp.cross."""
    rng = np.random.default_rng(23)
    for d in (3, 4):
        a = rng.normal(size=(513, d)).astype(np.float32)
        b = rng.normal(size=(513, d)).astype(np.float32)
        assert_bits(jm3.dot(jnp.asarray(a), jnp.asarray(b)),
                    pm3.dot(T(a), T(b)))
        assert_bits(jm3.length(jnp.asarray(a)), pm3.length(T(a)))
        assert_bits(jm3.normalize(jnp.asarray(a)), pm3.normalize(T(a)))
        assert_bits(jm3.lerp(jnp.asarray(a), jnp.asarray(b),
                             jnp.float32(0.3)),
                    pm3.lerp(T(a), T(b), 0.3))
    a = rng.normal(size=(513, 3)).astype(np.float32)
    b = rng.normal(size=(513, 3)).astype(np.float32)
    got = pm3.cross(T(a), T(b))
    i, j = np.array([1, 2, 0]), np.array([2, 0, 1])
    assert_bits(a[:, i] * b[:, j] - a[:, j] * b[:, i], got)
    ref = np.asarray(jm3.cross(jnp.asarray(a), jnp.asarray(b)))
    slack = 2.0 ** -23 * (np.abs(a[:, i] * b[:, j])
                          + np.abs(a[:, j] * b[:, i]))
    assert np.all(np.abs(got.numpy() - ref) <= slack)


def test_orthographic_and_look_at():
    """orthographic is bit for bit. look_at goes through cross twice, which
    the reference contracts to FMAs (see above): bit for bit where the
    products are exact (an axis-aligned camera), else within 1e-6 of
    entries of size <= |eye|."""
    assert_bits(jm3.orthographic(-2, 3, -1.5, 1.5, 0.1, 40.0),
                pm3.orthographic(-2, 3, -1.5, 1.5, 0.1, 40.0, device=CPU))
    assert_bits(jm3.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                pm3.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0), device=CPU))
    eye, target, up = (1.5, -2.0, 3.25), (0.3, 0.1, -4.0), (0.1, 1.0, 0.2)
    got = pm3.look_at(eye, target, up, device=CPU).numpy()
    np.testing.assert_allclose(got, np.asarray(jm3.look_at(eye, target, up)),
                               rtol=0, atol=1e-6)
    # a rigid transform that takes the eye to the origin
    np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                               atol=1e-6)
    np.testing.assert_allclose(got @ np.array([*eye, 1.0], np.float32),
                               [0, 0, 0, 1], atol=1e-6)


def test_rotate_axis_within_a_few_ulp():
    """cos and sin may differ from jnp's in the last ulp (see the rotations
    above), and an entry is a sum of three products of them: each entry
    within 4 ulps of an entry-sized value (an entry near 0 by cancellation
    is compared absolutely), and about a coordinate axis the matrix is that
    axis's rotation."""
    for axis, theta in (((0, 0, 1), 0.3), ((1, 2, -0.5), 1.1),
                        ((-3, 0.2, 0.9), -2.4)):
        ref = np.asarray(jm3.rotate_axis(axis, theta))
        got = pm3.rotate_axis(axis, theta, device=CPU).numpy()
        assert got.dtype == np.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * 2.0 ** -24)
    np.testing.assert_allclose(
        pm3.rotate_axis((0, 1, 0), 0.48, device=CPU).numpy(),
        pm3.rotate_y(0.48, device=CPU).numpy(), rtol=0, atol=2.0 ** -24)


def test_vertex_transform_and_triangle_setup_bit_exact():
    """The indexed vertex path: vertex_transform then triangle_setup on a
    mesh, against the reference's; it equals the corner path the draws use."""
    from dtrenderer_tpu.models import primitives as jprim

    w, h = 160, 120
    mesh = jprim.uv_sphere(10, 14)
    mvp = jm3.mat4mul(jnp.asarray(jm3.perspective(np.pi / 3, w / h, 0.1, 50.0)),
                      jm3.model_matrix((0.2, -0.1, -2.2), jm3.rotate_y(0.7)))
    ref_s = jgeo.vertex_transform(mesh.verts, mvp, w, h)
    got_s = pgeo.vertex_transform(T(mesh.verts), T(mvp), w, h)
    assert_bits(ref_s, got_s)
    for cull in (True, False):
        ref = jgeo.triangle_setup(ref_s, mesh.faces, w, h, cull)
        got = pgeo.triangle_setup(got_s, T(mesh.faces, np.int32), w, h, cull)
        assert_bits(ref.coef, got.coef)
        assert_bits(ref.bbox, got.bbox)
        assert_bits(ref.valid, got.valid)
        assert 0 < int(got.valid.sum())


# ------------------------------------------------------------------ audits


def _audit_scene(n=1200, h=64, w=128):
    """tests/test_shard.py's budget soup, in both packages."""
    from dtrenderer_tpu.models import primitives as jprim
    from dtrenderer_tpu.ops.pipeline import DrawSpec as JDrawSpec
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec as PDrawSpec

    soup = jprim.random_triangle_soup(n, rng_seed=7, extent=1.2)
    mdl = jnp.asarray(jm3.model_matrix((0, 0, -2.5), jm3.rotate_y(0.3)))
    proj = jnp.asarray(jm3.perspective(np.pi / 3, w / h, 0.1, 50.0))
    return (proj, [JDrawSpec(soup, mdl)], T(proj),
            [PDrawSpec(convert.mesh(soup, CPU), T(mdl))], soup, mdl, h, w)


def test_audit_scene_and_ordered_against_reference():
    """audit_scene / audit_ordered: overflow 0 and no capacity (None); the
    deepest tile's count equals the reference's when the reference bins at
    the port's 16x16 tile without its small/broad split (small_span above
    every span, as test_torch_binning.py does)."""
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu_torch.ops import pipeline as ppipe

    jproj, jdraws, proj, draws, soup, mdl, h, w = _audit_scene()
    ov, mx, cap = ppipe.audit_scene(proj, draws, h, w, near_clip=False)
    ref = jpipe.audit_scene(jproj, jdraws, h, w, near_clip=False,
                            raster_opts=dict(tile_h=16, tile_w=16,
                                             capacity=512, small_span=64))
    assert (ov, cap) == (0, None) and ref[0] == 0
    assert mx == ref[1] > 1
    ov3, mx3, cap3 = ppipe.audit_ordered(proj, draws[0].mesh, draws[0].model,
                                         h, w, near_clip=False)
    assert (ov3, mx3, cap3) == (0, mx, None)
    with pytest.raises(NotImplementedError, match="capacity"):
        ppipe.audit_scene(proj, draws, h, w, raster_opts=dict(capacity=8))
    with pytest.raises(NotImplementedError, match="tile_h"):
        ppipe.audit_ordered(proj, draws[0].mesh, draws[0].model, h, w,
                            raster_opts=dict(tile_h=16))


@pytest.mark.parametrize("opts", [None, dict(row_bands=8),
                                  dict(row_bands=8, band_shared=False)],
                         ids=["per_band", "shared", "shared_off"])
def test_audit_bands_against_reference(opts):
    """audit_bands: the reference's keys; band_tris equal the reference's
    (a host count over the same bboxes); band_pairs are those of the bins
    the banded render reads; budgets None, nothing dropped."""
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu_torch.ops import binning as pb, pipeline as ppipe

    jproj, jdraws, proj, draws, soup, mdl, h, w = _audit_scene()
    rep = ppipe.audit_bands(proj, draws, h, w, 8, near_clip=False,
                            raster_opts=opts)
    ref = jpipe.audit_bands(jproj, jdraws, h, w, 8, near_clip=False,
                            raster_opts=dict(tile_h=8, capacity=512,
                                             small_span=8))
    assert set(rep) == set(ref)
    assert ref["ok"] and rep["ok"]
    assert (rep["n_bands"], rep["band_h"]) == (8, 8) == (ref["n_bands"],
                                                         ref["band_h"])
    assert rep["band_tris"] == ref["band_tris"]
    assert rep["shared"] == (opts == dict(row_bands=8))
    assert rep["shard_budget"] is None and rep["pair_budget"] is None
    assert rep["shard_overflow"] == 0 and rep["pair_overflow"] == 0
    batch = ppipe.pack_draws(draws, proj, ppipe.make_light(device=CPU),
                             "nearest", w, h, near_clip=False)
    want = [int(pb.bin_triangles(batch.coef, batch.bbox, batch.valid, 8, w,
                                 b * 8).tri_ids.shape[0]) for b in range(8)]
    assert rep["band_pairs"] == want and min(want) > 0
    # every band's pairs cover at least its triangles
    assert all(p >= t for p, t in zip(rep["band_pairs"], rep["band_tris"]))
    with pytest.raises(ValueError, match="must divide"):
        ppipe.audit_bands(proj, draws, h, w, 7)


def test_device_time_on_the_cpu():
    """benchlib.device_time on CPU tensors: the host clock around `iters`
    calls after `warmup_iters`, the median over `repeats`."""
    from dtrenderer_tpu_torch.utils import benchlib

    calls = []

    def fn(x, y):
        calls.append(1)
        return x @ y

    x = torch.ones((64, 64))
    dt = benchlib.device_time(fn, x, x, iters=5, warmup_iters=2, repeats=3)
    assert len(calls) == 2 + 3 * 5
    assert 0 < dt < 1.0


def test_device_time_needs_a_device_when_no_argument_is_a_tensor():
    """Without a tensor among the arguments device_time does not guess a
    device: `device` says where fn runs, and without it the call raises."""
    from dtrenderer_tpu_torch.utils import benchlib

    calls = []
    with pytest.raises(ValueError, match="device="):
        benchlib.device_time(lambda: calls.append(1), iters=2)
    assert not calls
    dt = benchlib.device_time(lambda: calls.append(1), device="cpu", iters=3,
                              warmup_iters=1)
    assert len(calls) == 4 and dt >= 0

"""Degenerate and non-finite inputs through every route of the port, against
the JAX reference on the CPU (dtrenderer_tpu_torch/models/edge_cases.py has
the cases).

Each case is drawn once by the reference (one jitted frame: its "ref" or
"pallas" draw_mesh, or for the textured case its "fused" draw_meshes, the
Pallas kernels in interpret mode as the reference's own tests run them) and
by the port on five routes: backend "fused" (K1's plain twin, one
draw_meshes), "pallas" (K2's twin) and "ref", draw_mesh_ordered on engine
"tile" (K3's twin) and "scan"; K3's twin also draws the packed batch, which
puts a texture at LUT base > 0. The bar (ARCHITECTURE.md "Correctness
chain"): the same covered pixels, depth within the reference's FMA noise,
colour NaN at the same pixels and packed u8 within +-1 with zero outliers
elsewhere, and the winning triangle ids of the reference's raster equal to
those of the port's "ref" raster and of K2's twin.

`math3d.to_i32` is held to XLA's float-to-int32 conversion on the values
where C++ leaves the cast undefined, and the texture fetches of
`sampling.sample` to the reference's for such UVs.

The `gpu` test draws every case on every route on the card and on the CPU
(python -m pytest --noconftest -m gpu tests/test_torch_edge_cases.py); it
imports no JAX.
"""

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import raster_ordered as pro
from dtrenderer_tpu_torch.ops import raster_pallas as prp
from dtrenderer_tpu_torch.ops import sampling as psampling
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

CPU = torch.device("cpu")
LIGHT = make_light(*ec.LIGHT, device=CPU)
Z_REL = 1e-4
# the reference's route per case: the "larger than capacity" soup against
# its unbinned "ref" (the port's bins drop nothing), the +-1e12 vertices too
# (its binned routes draw such a triangle by their tile size, see
# geometry.triangle_setup_from_corners), the textured case through the
# fused kernel's texture LUT
JAX_ROUTE = {
    "single_triangle": "pallas", "nan_vertices": "pallas",
    "offscreen_cube": "ref", "far_subpixel_cube": "pallas",
    "crammed_soup": "ref", "nonfinite_uvs": "fused", "huge_vertices": "ref",
    "camera_in_box": "ref", "triangle_fan": "pallas",
    "integer_edges": "pallas",
}
BAD_F32 = np.array([np.nan, np.inf, -np.inf, 2.0**31, -2.0**31, 2147483520.0,
                    -2147483520.0, 1e12, -1e12, -0.0, 0.5, -0.5, 1.5, -1.5,
                    3e9, -3e9, 7.99, -7.99], np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several pytest workers on a few cores; torch's
    intra-op pool in each of them would oversubscribe the cores, and these
    small eager tensors gain nothing from it. Values do not depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- to_i32


def test_to_i32_is_xlas_conversion():
    import jax.numpy as jnp

    want = np.asarray(jnp.asarray(BAD_F32, jnp.float32).astype(jnp.int32))
    got = pm3.to_i32(torch.from_numpy(BAD_F32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # +-1 after the conversion wraps as the reference's int32 does
    np.testing.assert_array_equal((got + 1).numpy(), want + np.int32(1))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_sampling_fetches_the_references_texel(mode):
    """u and v over the values above and in range, in every pairing: the
    texel, or for bilinear the NaN of inf - inf, is the reference's."""
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import sampling as jsampling

    tex = ec._texture(3, 4, 8)
    vals = np.concatenate([BAD_F32, np.float32([0.3, 0.7, 1.0, 0.0])])
    u, v = [a.ravel() for a in np.meshgrid(vals, vals)]
    want = np.asarray(jsampling.sample(jnp.asarray(tex), jnp.asarray(u),
                                       jnp.asarray(v), mode))
    got = psampling.sample(torch.from_numpy(tex), torch.from_numpy(u),
                           torch.from_numpy(v), mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_bbox_of_a_vertex_beyond_2_31_pixels():
    """The port clamps the bbox's bounds in float before it converts them;
    the reference converts first, and its bbox of such a triangle comes out
    inverted or collapsed to the frame's last row or column (the conversion
    saturates, the +-1 wraps), so it misses pixels the triangle covers. In
    range the two are equal; beyond, the port's holds every such pixel."""
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import geometry as jgeo
    from dtrenderer_tpu_torch.ops import geometry as pgeo

    h, w = 32, 128
    tris = np.array([[(10, 10), (40, 12), (1e12, 20)],
                     [(100, 12), (120, 10), (-1e12, 20)],
                     [(10, 10), (40, 12), (60, 1e12)],
                     [(70, 30), (110, 28), (90, -1e12)],
                     [(10, 10), (40, 12), (30, 25)]], np.float32)
    corners = np.zeros(tris.shape[:2] + (4,), np.float32)
    corners[..., :2] = tris
    corners[..., 2:] = (0.5, 1.0)
    ref = jgeo.triangle_setup_from_corners(
        *[jnp.asarray(corners[:, i]) for i in range(3)], w, h, False)
    got = pgeo.triangle_setup_from_corners(
        *[torch.from_numpy(corners[:, i]) for i in range(3)], w, h, False)
    np.testing.assert_array_equal(got.coef.numpy(), np.asarray(ref.coef))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    rb, pb = np.asarray(ref.bbox), got.bbox.numpy()
    np.testing.assert_array_equal(pb[4], rb[4])

    def holds(b, xs, ys):
        return (b[0] <= xs.min() and xs.max() <= b[2]
                and b[1] <= ys.min() and ys.max() <= b[3])

    for t in range(5):
        _, tri = rasterize_ref(got.coef[t:t + 1], got.valid[t:t + 1], h, w)
        ys, xs = np.nonzero(tri.numpy() == 0)
        assert len(xs) > 0 and holds(pb[t], xs, ys)
        assert holds(rb[t], xs, ys) == (t == 4)


# ------------------------------------------------------------ the cases


def _jax_frame(case, route):
    """The reference's frame of a case: (color, depth, ids or None)."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.models.mesh import make_mesh as jmake_mesh
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.raster_pallas import rasterize_pallas
    from dtrenderer_tpu.ops.raster_ref import rasterize_ref as jraster_ref
    from dtrenderer_tpu.ops.shading import make_light as jmake_light
    from dtrenderer_tpu.utils import math3d as jm3

    light = jmake_light(*ec.LIGHT)
    vp = jnp.asarray(case.view_proj)
    draws = [(jmake_mesh(*d.arrays), jnp.asarray(d.model),
              None if d.texture is None else jnp.asarray(d.texture), d)
             for d in case.draws]
    h, w = case.height, case.width
    kw = dict(light=light, cull_backfaces=case.cull_backfaces,
              near_clip=case.near_clip)

    @jax.jit
    def frame(color, depth):
        fb = jfb.Framebuffer(color, depth)
        if route == "fused":
            specs = [jpipe.DrawSpec(m, mdl, texture=t, color=d.color,
                                    shading=d.shading, sampling=d.sampling)
                     for m, mdl, t, d in draws]
            return jpipe.draw_meshes(fb, vp, specs, **kw), None
        for m, mdl, t, d in draws:
            fb = jpipe.draw_mesh(fb, m, mdl, vp, texture=t, color=d.color,
                                 shading=d.shading, sampling_mode=d.sampling,
                                 backend=route, **kw)
        (m, mdl, _, d), = draws
        setup, _ = jpipe.prepare_draw(
            m, mdl, vp, jm3.mat4mul(vp, mdl), mdl, light, d.color, d.shading,
            w, h, case.cull_backfaces, case.near_clip)
        if route == "ref":
            _, ids = jraster_ref(setup.coef, setup.valid, h, w)
        else:
            _, ids, _ = rasterize_pallas(setup.coef, setup.bbox, setup.valid,
                                         h, w)
        return fb, ids

    fb0 = pfb.clear(pfb.create(h, w, CPU), ec.CLEAR)
    out, ids = frame(jnp.asarray(fb0.color.numpy()),
                     jnp.asarray(fb0.depth.numpy()))
    return (np.array(out.color), np.array(out.depth),
            None if ids is None else np.array(ids))


def _port_ids(case):
    """The winning ids of the port's "ref" raster and of K2's twin."""
    (spec,) = ec.draw_specs(case, CPU)
    vp = torch.from_numpy(case.view_proj)
    setup, _ = ppipe.prepare_draw(
        spec.mesh, spec.model, vp, pm3.mat4mul(vp, spec.model), spec.model,
        LIGHT, spec.color, spec.shading, case.width, case.height,
        case.cull_backfaces, case.near_clip)
    _, ids_ref = rasterize_ref(setup.coef, setup.valid, case.height,
                               case.width)
    _, ids_k2, _ = prp.rasterize_pallas(setup.coef, setup.bbox, setup.valid,
                                        case.height, case.width)
    return ids_ref.numpy(), ids_k2.numpy()


def _assert_bar(tag, color, depth, ref_color, ref_depth):
    covered = np.isfinite(ref_depth)
    np.testing.assert_array_equal(np.isfinite(depth), covered, err_msg=tag)
    np.testing.assert_array_equal(depth[~covered], ref_depth[~covered],
                                  err_msg=tag)
    np.testing.assert_allclose(depth[covered], ref_depth[covered],
                               rtol=Z_REL, atol=0, err_msg=tag)
    nan = np.isnan(color)
    np.testing.assert_array_equal(nan, np.isnan(ref_color), err_msg=tag)
    ok = ~nan.any(-1)
    du8 = np.abs(ppack(torch.from_numpy(color)).numpy().astype(int)
                 - ppack(torch.from_numpy(ref_color)).numpy().astype(int))
    assert du8[ok].max(initial=0) <= 1, (
        f"{tag}: {(du8[ok] > 1).sum()} packed u8 channels differ by > 1")


def _semantics(name, case, color, depth, ids):
    """What the reference's own tests ask of each case."""
    cov = np.isfinite(depth)
    if name in ("single_triangle", "nan_vertices"):
        assert cov.sum() > 10, "the good triangle was dropped"
    if name == "offscreen_cube":
        assert not cov.any() and np.allclose(color[..., :3], 0.0)
    if name == "nonfinite_uvs":
        # nearest fetches a texel for every UV; bilinear's weight of an
        # infinite coordinate is inf - inf = NaN, in the reference too
        assert np.isfinite(color[:, :64]).all() and cov[:, :64].sum() > 500
        assert np.isnan(color[:, 64:]).any()
    elif name != "offscreen_cube":
        assert np.isfinite(color).all(), "NaN leaked into the framebuffer"
    if name == "huge_vertices":
        assert len(np.unique(ids)) == 5  # each of the four, and no triangle
    if name == "camera_in_box":
        assert cov.mean() > 0.95
    if name == "integer_edges":
        ys, xs = np.nonzero(cov)
        assert (ys.min(), ys.max(), xs.min(), xs.max()) == (8, 15, 8, 23)
        assert cov.sum() == 16 * 8
    if name == "triangle_fan":
        # tests/test_fill_rule.py: each triangle alone, every pixel
        # covered once across the fan's shared edges
        (spec,) = ec.draw_specs(case, CPU)
        vp = torch.from_numpy(case.view_proj)
        setup, _ = ppipe.prepare_draw(
            spec.mesh, spec.model, vp, pm3.mat4mul(vp, spec.model),
            spec.model, LIGHT, spec.color, spec.shading, case.width,
            case.height, False, case.near_clip)
        total = sum(
            (rasterize_ref(setup.coef[t:t + 1], setup.valid[t:t + 1],
                           case.height, case.width)[1] >= 0).int()
            for t in range(setup.coef.shape[0]))
        assert int(total.max()) == 1 and int(total[16, 64]) == 1
        assert np.array_equal(total.numpy() > 0, cov)


@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_case_matches_reference_on_every_route(name):
    case = ec.CASES[name]()
    ref_color, ref_depth, ref_ids = _jax_frame(case, JAX_ROUTE[name])
    for route in ec.ROUTES:
        out = ec.render(case, route, CPU, LIGHT)
        _assert_bar(f"{name} on {route}", out.color.numpy(),
                    out.depth.numpy(), ref_color, ref_depth)
    # K3's twin over the packed batch: every draw's texture at its LUT base
    batch, _, _ = ec.pack(case, CPU, LIGHT)
    fb0 = pfb.clear(pfb.create(case.height, case.width, CPU), ec.CLEAR)
    color, depth, _ = pro.render_ordered(
        batch.coef, batch.bbox, batch.valid, batch.payload, batch.tex_lut,
        LIGHT, fb0.color, fb0.depth, case.height, case.width)
    _assert_bar(f"{name} on K3 over the batch", color.numpy(), depth.numpy(),
                ref_color, ref_depth)
    if ref_ids is not None:
        for ids in _port_ids(case):
            np.testing.assert_array_equal(ids, ref_ids)
    _semantics(name, case, ref_color, ref_depth, ref_ids)


# --------------------------------------------------------------------- gpu


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_case_card_equals_cpu(name):
    """Every route on the card against the CPU: depth bit-equal, colour NaN
    at the same pixels and within 1e-6 elsewhere (run: pytest -m gpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    case = ec.CASES[name]()
    x = torch.from_numpy(BAD_F32)
    assert torch.equal(pm3.to_i32(x.to(dev)).cpu(), pm3.to_i32(x))
    for route in ec.ROUTES:
        card, cpu = ec.render(case, route, dev), ec.render(case, route, CPU)
        assert torch.equal(card.depth.cpu().view(torch.int32),
                           cpu.depth.view(torch.int32)), route
        c_card, c_cpu = card.color.cpu(), cpu.color
        nan = torch.isnan(c_cpu)
        assert torch.equal(torch.isnan(c_card), nan), route
        diff = torch.where(nan, 0.0, c_card - c_cpu).abs()
        assert float(diff.max()) <= 1e-6, route

"""The port's submission-order (translucency) path against the JAX
reference and the NumPy sequential-blend oracle.

  * draw_mesh_ordered on engine "tile" (raster_ordered.render_ordered, its
    CPU twin render_ordered_plain) and engine "scan" (the per-triangle loop)
    are bit-equal to each other, at every scan window size;
  * both are bit-equal to tests/oracle_pipeline.MeshOracle.render_sequential
    (FORMULAS.md with no FMA on either side);
  * against the reference's draw_mesh_ordered(engine="tile") (Pallas
    interpret mode), at tests/test_translucency.py's bar: packed u8 within
    +-1 with zero outliers, the same covered pixels, depth within 1e-4
    relative (XLA:CPU contracts FMAs inside the reference);
  * opaque geometry: ordered == fused == ref bit for bit; draw_meshes cuts
    a submission into opaque runs and translucent singles, in order, and
    near clipping keeps the order of the two rows a clipped triangle makes.

The `gpu` test compares the CUDA kernel with its plain twin on the card
(python -m pytest --noconftest -m gpu tests/test_torch_ordered.py).
"""

import numpy as np
import pytest
import torch

import oracle
from oracle_pipeline import MeshOracle
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models.mesh import make_mesh
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import raster_ordered as pro
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

CPU = torch.device("cpu")
H, W = 60, 80
CLEAR = (0.05, 0.05, 0.1, 1.0)
LIGHT = ((0.3, 0.5, 1.0), 0.15)


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


def _two_overlapping_tris_np():
    """tests/test_translucency.py::_two_overlapping_tris: the far triangle
    first, the near one over its middle."""
    verts = np.array([[-0.7, -0.6, -0.2], [0.7, -0.5, -0.2], [0.0, 0.7, -0.2],
                      [-0.5, -0.3, 0.2], [0.6, -0.2, 0.2], [0.1, 0.5, 0.2]],
                     np.float32)
    return (verts, np.zeros((6, 2), np.float32),
            np.tile([[0, 0, 1]], (6, 1)).astype(np.float32),
            np.array([[0, 1, 2], [3, 4, 5]], np.int32))


def _mesh_np(name):
    """(verts, uv, normals, faces) numpy arrays of a case's mesh."""
    if name == "two_tris":
        return _two_overlapping_tris_np()
    if name == "sphere":
        m = pprim.uv_sphere(10, 12, device=CPU)
    elif name == "soup":
        # 400 overlapping triangles of a few pixels to a third of the frame
        rng = np.random.default_rng(9)
        verts = (rng.uniform(-0.6, 0.6, (400, 1, 3))
                 + rng.uniform(-0.25, 0.25, (400, 3, 3))).astype(np.float32)
        m = make_mesh(verts.reshape(-1, 3),
                      rng.uniform(0, 1, (1200, 2)).astype(np.float32),
                      device=CPU)
    else:
        raise KeyError(name)
    return tuple(t.numpy() for t in m)


# case -> (mesh, colour or None for white, shading, sampling, textured,
#          model translation, near_clip)
CASES = {
    "two_tris_none": ("two_tris", (0.9, 0.4, 0.2, 0.45), "none", "nearest",
                      False, (0, 0, -2.0), True),
    "two_tris_textured_gouraud": ("two_tris", (0.8, 0.8, 0.9, 0.6),
                                  "gouraud", "bilinear", True, (0, 0, -2.0),
                                  True),
    "sphere_phong_bilinear": ("sphere", (0.9, 0.7, 0.5, 0.55), "phong",
                              "bilinear", True, (0, 0, -2.0), True),
    "sphere_white_phong": ("sphere", None, "phong", "bilinear", True,
                           (0, 0, -2.0), True),
    "soup_flat_nearest": ("soup", (0.8, 0.4, 0.3, 0.5), "flat", "nearest",
                          True, (0, 0, -1.2), False),
}


def _inputs(case):
    mesh_name, color, shading, sampling, textured, pos, near_clip = \
        CASES[case]
    arrays = _mesh_np(mesh_name)
    tex = oracle_tex = None
    if textured:
        tex = pprim.checkerboard(8, 2, device=CPU)
        oracle_tex = tex.numpy()
    return dict(arrays=arrays, color=color or (1.0, 1.0, 1.0, 1.0),
                shading=shading, sampling=sampling, tex=tex,
                oracle_tex=oracle_tex, pos=pos, near_clip=near_clip)


def _matrices(pos, device=CPU):
    model = pm3.translate(pos, device=device)
    proj = pm3.perspective(np.pi / 3, W / H, 0.1, 50.0, device=device)
    return model, proj


def _clear_fb(device=CPU):
    return pfb.clear(pfb.create(H, W, device), list(CLEAR))


def _port(case, engine, window=(64, 128), device=CPU, counters=False):
    k = _inputs(case)
    mesh = make_mesh(*k["arrays"], device=device)
    model, proj = _matrices(k["pos"], device)
    tex = None if k["tex"] is None else k["tex"].to(device)
    return ppipe.draw_mesh_ordered(
        _clear_fb(device), mesh, model, proj, texture=tex,
        light=make_light(*LIGHT, device=device), color=k["color"],
        shading=k["shading"], sampling_mode=k["sampling"],
        near_clip=k["near_clip"], window=window, engine=engine,
        return_counters=counters)


def _assert_reference_bar(color, depth, ref_color, ref_depth):
    """tests/test_translucency.py:73-88."""
    du8 = np.abs(ppack(color).numpy().astype(int)
                 - oracle.pack_srgb_u8(np.asarray(ref_color)).astype(int))
    assert (du8 > 1).sum() == 0, f"{(du8 > 1).sum()} u8 channels differ > 1"
    z, zr = depth.numpy(), np.asarray(ref_depth)
    finite = np.isfinite(zr)
    np.testing.assert_array_equal(np.isfinite(z), finite)
    np.testing.assert_allclose(z[finite], zr[finite], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_twin_equals_scan_bit_exact(case):
    (ta, ca), (sa, cs) = (_port(case, "tile", counters=True),
                          _port(case, "scan", counters=True))
    assert torch.isfinite(ta.depth).sum() > 300
    assert torch.equal(ta.depth.view(torch.int32), sa.depth.view(torch.int32))
    assert torch.equal(ta.color.view(torch.int32), sa.color.view(torch.int32))
    for a, b in zip(ca, cs):
        assert int(a) == int(b)


@pytest.mark.parametrize("case", ["two_tris_none",
                                  "two_tris_textured_gouraud",
                                  "sphere_phong_bilinear",
                                  "sphere_white_phong"])
def test_ordered_matches_sequential_oracle_bit_exact(case):
    k = _inputs(case)
    out = _port(case, "tile")
    model, proj = _matrices(k["pos"])
    verts, uv, normals, faces = k["arrays"]
    tex = k["oracle_tex"]
    mo = MeshOracle(verts, uv, normals, faces, model.numpy(),
                    pm3.mat4mul(proj, model).numpy(), model.numpy(),
                    tex if tex is not None else np.ones((1, 1, 4),
                                                        np.float32),
                    *LIGHT, k["color"], k["shading"], k["sampling"], True, H,
                    W)
    ref_c, ref_z = mo.render_sequential(
        np.broadcast_to(np.float32(CLEAR), (H, W, 4)).copy(),
        np.full((H, W), np.inf, np.float32))
    np.testing.assert_array_equal(out.depth.numpy().view(np.int32),
                                  ref_z.view(np.int32))
    np.testing.assert_array_equal(out.color.numpy().view(np.int32),
                                  ref_c.view(np.int32))


def _reference_ordered(case):
    """The reference's draw_mesh_ordered(engine="tile") of a case."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.models.mesh import make_mesh as jmake_mesh
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.shading import make_light as jmake_light

    k = _inputs(case)
    model, proj = _matrices(k["pos"])
    mesh = jmake_mesh(*k["arrays"])
    tex = None if k["tex"] is None else jnp.asarray(k["oracle_tex"])

    @jax.jit
    def run(color, depth):
        return jpipe.draw_mesh_ordered(
            jfb.Framebuffer(color, depth), mesh, jnp.asarray(model.numpy()),
            jnp.asarray(proj.numpy()), texture=tex,
            light=jmake_light(*LIGHT), color=k["color"],
            shading=k["shading"], sampling_mode=k["sampling"],
            near_clip=k["near_clip"], engine="tile")

    fb = _clear_fb()
    out = run(jnp.asarray(fb.color.numpy()), jnp.asarray(fb.depth.numpy()))
    return out.color, out.depth


@pytest.mark.parametrize("case", ["two_tris_textured_gouraud",
                                  "sphere_phong_bilinear",
                                  "soup_flat_nearest"])
def test_ordered_matches_reference_tile_engine(case):
    ref_color, ref_depth = _reference_ordered(case)
    for engine in ("tile", "scan"):
        out = _port(case, engine)
        _assert_reference_bar(out.color, out.depth, ref_color, ref_depth)


@pytest.mark.parametrize("window", [(8, 32), (16, 128), (64, 128), None])
def test_scan_window_sizes_bit_equal(window):
    """tests/test_translucency.py:367: the scan engine is bit-equal at any
    window size (windows smaller than some triangles take the whole frame;
    None always does), and equal to the tile engine."""
    whole = _port("soup_flat_nearest", "scan", window=(H, W))
    got = _port("soup_flat_nearest", "scan", window=window)
    tile = _port("soup_flat_nearest", "tile")
    for out in (got, tile):
        assert torch.equal(out.color, whole.color)
        assert torch.equal(out.depth, whole.depth)


def _opaque_cube_draws():
    cube = pprim.cube(device=CPU)
    model = pm3.model_matrix((0, 0, -4.0), pm3.rotate_y(0.7, device=CPU),
                             device=CPU)
    _, proj = _matrices((0, 0, 0))
    return cube, model, proj, pprim.checkerboard(8, 2, device=CPU)


def test_ordered_equals_unordered_for_opaque():
    """tests/test_translucency.py:148: with strict `<`, a later triangle at
    equal depth loses, so on opaque geometry the ordered path is the
    (min z, min id) rule: equal to backend="fused" and "ref" bit for bit."""
    cube, model, proj, tex = _opaque_cube_draws()
    light = make_light((0.4, 0.6, 1.0), 0.15, device=CPU)
    kw = dict(texture=tex, light=light, shading="gouraud",
              sampling_mode="bilinear")
    outs = [ppipe.draw_mesh_ordered(_clear_fb(), cube, model, proj,
                                    engine=e, **kw) for e in ("tile", "scan")]
    outs += [ppipe.draw_mesh(_clear_fb(), cube, model, proj, backend=b, **kw)
             for b in ("fused", "ref")]
    assert torch.isfinite(outs[0].depth).sum() > 500
    for out in outs[1:]:
        assert torch.equal(out.depth, outs[0].depth)
        assert torch.equal(out.color, outs[0].color)


def _interleaved_specs(device=CPU):
    cube = pprim.cube(device=device)
    sphere = pprim.uv_sphere(6, 8, device=device)
    tmesh = make_mesh(*_two_overlapping_tris_np(), device=device)
    mm = pm3.model_matrix
    m_cube = mm((0.2, 0, -5.0), pm3.rotate_y(0.4, device=device),
                device=device)
    m_sph = mm((-0.4, 0.1, -3.0), pm3.rotate_y(1.1, device=device),
               device=device)
    m_t = pm3.translate((0, 0, -2.0), device=device)
    return [
        ppipe.DrawSpec(cube, m_cube, shading="gouraud"),             # opaque
        ppipe.DrawSpec(tmesh, m_t, color=(0.9, 0.4, 0.2, 0.45),
                       shading="none"),                              # trans.
        ppipe.DrawSpec(sphere, m_sph, color=(0.5, 0.8, 0.6, 1.0),
                       shading="gouraud"),                           # opaque
    ]


def _sequential(fb, proj, light, specs):
    for d in specs:
        draw = ppipe.draw_mesh_ordered if ppipe.is_translucent_draw(d) else \
            ppipe.draw_mesh
        extra = {} if draw is ppipe.draw_mesh_ordered else {"backend": "fused"}
        fb = draw(fb, d.mesh, d.model, proj, light=light, color=d.color,
                  shading=d.shading, sampling_mode="nearest", **extra)
    return fb


@pytest.mark.parametrize("order", ["translucent_first",
                                   "opaque_translucent_opaque"])
def test_draw_meshes_partition_equals_sequential_draws(order):
    """tests/test_translucency.py:171 and :203: draw_meshes renders
    translucent specs in exact submission order, equal to the sequential
    composition of draw_mesh / draw_mesh_ordered, with merged counters."""
    _, proj = _matrices((0, 0, 0))
    light = make_light((0.4, 0.6, 1.0), 0.15, device=CPU)
    specs = _interleaved_specs()
    if order == "translucent_first":
        specs = [specs[1], specs[0]]
    out, c = ppipe.draw_meshes(_clear_fb(), proj, specs, light=light,
                               sampling_mode="nearest", return_counters=True)
    want = _sequential(_clear_fb(), proj, light, specs)
    assert torch.equal(out.color, want.color)
    assert torch.equal(out.depth, want.depth)
    rows = sum(2 * d.mesh.faces.shape[0] for d in specs)  # near clip: 1 -> 2
    assert int(c.tris_submitted) == rows
    assert int(c.bin_overflow) == 0
    assert int(c.pixels_shaded) >= int(torch.isfinite(out.depth).sum())


def _reference_mesh(mesh):
    from dtrenderer_tpu.models.mesh import make_mesh as jmake_mesh

    return jmake_mesh(*(t.numpy() for t in mesh))


def test_draw_meshes_interleaved_matches_reference():
    """The interleaved submission against the reference's draw_meshes
    (fused opaque runs and the ordered tile engine), at the u8 bar."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.shading import make_light as jmake_light

    _, proj = _matrices((0, 0, 0))
    specs = _interleaved_specs()
    jspecs = [jpipe.DrawSpec(
        _reference_mesh(d.mesh), jnp.asarray(d.model.numpy()),
        color=d.color, shading=d.shading) for d in specs]

    @jax.jit
    def run(color, depth):
        return jpipe.draw_meshes(
            jfb.Framebuffer(color, depth), jnp.asarray(proj.numpy()), jspecs,
            light=jmake_light((0.4, 0.6, 1.0), 0.15),
            sampling_mode="nearest", raster_opts=dict(capacity=4096))

    fb = _clear_fb()
    ref = run(jnp.asarray(fb.color.numpy()), jnp.asarray(fb.depth.numpy()))
    out = ppipe.draw_meshes(fb, proj, specs,
                            light=make_light((0.4, 0.6, 1.0), 0.15,
                                             device=CPU),
                            sampling_mode="nearest")
    _assert_reference_bar(out.color, out.depth, ref.color, ref.depth)


def test_near_clip_keeps_submission_order():
    """clip_near turns triangle i into setup rows 2i and 2i+1; submission
    order survives only if that order is kept. A translucent cube around the
    camera (every side crosses the near plane, no culling) drawn as one
    ordered draw equals the same triangles drawn one draw each, in order."""
    cube = pprim.cube(device=CPU)
    model = pm3.model_matrix((0.3, -0.2, -0.6),
                             pm3.rotate_y(0.5, device=CPU), 1.5, device=CPU)
    _, proj = _matrices((0, 0, 0))
    light = make_light(*LIGHT, device=CPU)
    kw = dict(light=light, color=(0.7, 0.5, 0.9, 0.4), shading="gouraud",
              cull_backfaces=False)
    setup, _ = ppipe.prepare_draw(
        cube, model, proj, pm3.mat4mul(proj, model), model, light, kw["color"],
        "gouraud", W, H, False, True)
    assert bool(setup.valid[1::2].any()), "no triangle was split in two"
    whole = {e: ppipe.draw_mesh_ordered(_clear_fb(), cube, model, proj,
                                        engine=e, **kw)
             for e in ("tile", "scan")}
    fb = _clear_fb()
    verts, uv, normals, faces = (t.numpy() for t in cube)
    for f in faces:
        one = make_mesh(verts[f], uv[f], normals[f], [[0, 1, 2]], device=CPU)
        fb = ppipe.draw_mesh_ordered(fb, one, model, proj, **kw)
    assert torch.isfinite(fb.depth).sum() > 1000
    for out in whole.values():
        assert torch.equal(out.color, fb.color)
        assert torch.equal(out.depth, fb.depth)


def test_auto_engine_is_tile_and_counters():
    auto, ca = _port("sphere_phong_bilinear", "auto", counters=True)
    tile, ct = _port("sphere_phong_bilinear", "tile", counters=True)
    assert torch.equal(auto.color, tile.color)
    assert torch.equal(auto.depth, tile.depth)
    n_faces = _inputs("sphere_phong_bilinear")["arrays"][3].shape[0]
    assert int(ca.tris_submitted) == 2 * n_faces  # setup rows (near clip)
    assert 0 < int(ca.tris_valid) < n_faces
    assert int(ca.pixels_shaded) == int(torch.isfinite(auto.depth).sum())
    assert [int(x) for x in ca] == [int(x) for x in ct]


def test_render_ordered_dispatch_on_cpu_is_the_plain_twin():
    k = _inputs("sphere_phong_bilinear")
    mesh = make_mesh(*k["arrays"], device=CPU)
    model, proj = _matrices(k["pos"])
    light = make_light(*LIGHT, device=CPU)
    batch = ppipe.pack_draws(
        [ppipe.DrawSpec(mesh, model, texture=k["tex"], color=k["color"],
                        shading="phong")], proj, light, "bilinear", W, H)
    bins = pbin.bin_triangles(batch.coef, batch.bbox, batch.valid, H, W)
    fb = _clear_fb()
    args = (batch.coef, batch.payload, bins, batch.tex_lut, light, fb.color,
            fb.depth, H, W)
    before = pro.KERNEL_LAUNCHES
    a = pro.render_ordered_bins(*args)
    b = pro.render_ordered_plain(*args)
    assert pro.KERNEL_LAUNCHES == before  # the CPU path launches nothing
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(fb.depth, torch.full((H, W), float("inf")))  # fresh
    with pytest.raises(ValueError, match="fb_color"):
        pro.render_ordered_bins(*args[:5], fb.color[:, :-1], *args[6:])
    with pytest.raises(ValueError, match="payload"):
        pro.render_ordered_bins(args[0], args[1][:, :30], *args[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_twin_on_gpu(case):
    """The CUDA kernel against its plain twin on the card: depth bit-equal,
    colour within 1e-6, and both equal to the CPU frame (run: pytest -m
    gpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    before = pro.KERNEL_LAUNCHES
    k_out = _port(case, "tile", device=dev)
    assert pro.KERNEL_LAUNCHES == before + 1
    cpu = _port(case, "tile")
    scan = _port(case, "scan", device=dev)
    for out in (k_out, scan):
        assert torch.equal(out.depth.cpu().view(torch.int32),
                           cpu.depth.view(torch.int32))
        assert (out.color.cpu() - cpu.color).abs().max() <= 1e-6

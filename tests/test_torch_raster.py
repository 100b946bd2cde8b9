"""The port's visibility rasterizers and deferred draw path against the JAX
reference, the NumPy scalar oracle and the config 1-3 goldens.

  * ops/sampling.py against tests/oracle.py's samplers (bit for bit) and the
    reference's (nearest bit for bit, bilinear within FMA noise);
  * raster_ref.rasterize_ref and raster_pallas.rasterize_pallas (its CPU
    twin, rasterize_pallas_plain) against oracle.rasterize bit for bit and
    against each other bit for bit; against the reference's rasterize_ref /
    rasterize_pallas (Pallas interpret mode) with the tri id equal and z
    within 1e-4 relative, each differing pixel explained as a near-tie or a
    near-edge flip of XLA:CPU's FMA contraction (test_torch_pipeline.py);
  * draw_mesh(backend="ref"/"pallas"): bit-equal to each other and to
    backend="fused", bit-equal to MeshOracle, and against the reference's
    draw and the config 1-3 goldens (160x120, t = 0.6, packed u8 within +-1).

The `gpu` tests compare the CUDA kernel with its plain twin on the card
(python -m pytest --noconftest -m gpu tests/test_torch_raster.py), also at
shapes the scenes do not reach: a bin deeper than two staging chunks, grids
of shared edges through pixel centres and along sub-block borders, and
ragged shards with non-zero offsets.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import oracle
from oracle_pipeline import MeshOracle
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models import scenes as pscenes
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import geometry as pgeo
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import raster_pallas as prp
from dtrenderer_tpu_torch.ops import sampling as psamp
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
from dtrenderer_tpu_torch.ops.shading import make_light as pmake_light
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

CPU = torch.device("cpu")
Z_REL = 1e-4
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
GOLDENS = {1: "config1_flat_triangle", 2: "config2_textured_cube",
           3: "config3_obj_gouraud"}


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


def _screen_tris(seed, n_tris, h, w, size=25):
    """tests/test_raster_pallas.py::_random_screen_tris, from a seed."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-10, w + 10, n_tris),
                  rng.uniform(-10, h + 10, n_tris)], 1)[:, None, :]
    off = rng.uniform(-size, size, (n_tris, 3, 2))
    screen = np.zeros((n_tris * 3, 4), np.float32)
    screen[:, :2] = (c + off).reshape(-1, 2)
    screen[:, 2] = rng.uniform(0, 1, n_tris * 3)
    screen[:, 3] = 1.0
    return screen, np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)


def _scene(case):
    """-> (screen, faces, h, w, cull) of the mirrors of
    tests/test_raster_pallas.py:40-59."""
    if case == "small":
        return (*_screen_tris(40, 50, 96, 256), 96, 256, False)
    if case == "mixed_sizes":
        screen, faces = _screen_tris(45, 30, 96, 256)
        big, bigf = _screen_tris(46, 4, 96, 256, size=150)
        return (np.concatenate([screen, big]),
                np.concatenate([faces, bigf + 90]), 96, 256, False)
    if case == "depth_ties":
        screen, faces = _screen_tris(54, 30, 64, 128)
        screen[:, 0] = 64 + (screen[:, 0] - 64) * 0.2
        screen[:, 1] = 32 + (screen[:, 1] - 32) * 0.2
        screen[:, 2] = np.round(screen[:, 2] * 3) / 3
        return screen, faces, 64, 128, False
    if case == "culled":
        return (*_screen_tris(62, 60, 64, 128), 64, 128, True)
    raise KeyError(case)


def _setup(screen, faces, h, w, cull):
    s = convert.tensor(screen, CPU)
    f = torch.as_tensor(faces, dtype=torch.int64)
    return pgeo.triangle_setup_from_corners(s[f[:, 0]], s[f[:, 1]],
                                            s[f[:, 2]], w, h, cull)


def _assert_matches_reference(z_p, tri_p, z_r, tri_r, setup):
    """tri equal and z within Z_REL, except at rare pixels that a near-tie
    or a near-edge FMA flip explains (test_torch_pipeline._explained)."""
    from test_torch_pipeline import _explained

    z_r, tri_r = np.asarray(z_r), np.asarray(tri_r)
    both = np.isfinite(z_r) & np.isfinite(z_p)
    close = np.where(both, np.isclose(z_p, z_r, rtol=Z_REL, atol=0),
                     np.isfinite(z_r) == np.isfinite(z_p))
    bad = np.argwhere((tri_p != tri_r) | ~close)
    batch = SimpleNamespace(coef=setup.coef, valid=setup.valid)
    for y, x in bad:
        zr = z_r[y, x] if np.isfinite(z_r[y, x]) else z_p[y, x]
        assert _explained(batch, zr, y, x), (
            f"pixel {(y, x)}: tri {tri_p[y, x]} z {z_p[y, x]} vs reference "
            f"tri {tri_r[y, x]} z {z_r[y, x]}")
    assert len(bad) <= 5e-3 * max(1, np.isfinite(z_r).sum())


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_sampling_matches_oracle_and_reference(mode):
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import sampling as jsamp

    rng = np.random.default_rng(7)
    tex = rng.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    u = rng.uniform(-0.3, 1.3, 500).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, 500).astype(np.float32)
    got = psamp.sample(convert.texture(tex, CPU), convert.tensor(u, CPU),
                       convert.tensor(v, CPU), mode).numpy()
    orc = oracle.sample_nearest if mode == "nearest" else \
        oracle.sample_bilinear
    want = np.stack([orc(tex, u[i], v[i]) for i in range(len(u))])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = np.asarray(jsamp.sample(jnp.asarray(tex), jnp.asarray(u),
                                  jnp.asarray(v), mode))
    if mode == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-6
    with pytest.raises(ValueError, match="sampling"):
        psamp.sample(convert.texture(tex, CPU), convert.tensor(u, CPU),
                     convert.tensor(v, CPU), "trilinear")


# ------------------------------------------------------- visibility rasters


@pytest.mark.parametrize("case", ["small", "mixed_sizes", "depth_ties",
                                  "culled"])
def test_rasterize_ref_matches_scalar_oracle_bit_exact(case):
    screen, faces, h, w, cull = _scene(case)
    setup = _setup(screen, faces, h, w, cull)
    z, tri = rasterize_ref(setup.coef, setup.valid, h, w)
    z_o, tri_o = oracle.rasterize(screen, faces, h, w, cull_backfaces=cull)
    assert np.isfinite(z_o).sum() > 150
    np.testing.assert_array_equal(z.numpy().view(np.int32),
                                  z_o.view(np.int32))
    np.testing.assert_array_equal(tri.numpy(), tri_o)


@pytest.mark.parametrize("case", ["small", "mixed_sizes", "depth_ties",
                                  "culled"])
def test_rasterize_pallas_plain_equals_rasterize_ref(case):
    screen, faces, h, w, cull = _scene(case)
    setup = _setup(screen, faces, h, w, cull)
    z_r, tri_r = rasterize_ref(setup.coef, setup.valid, h, w)
    z_p, tri_p, overflow = prp.rasterize_pallas(setup.coef, setup.bbox,
                                                setup.valid, h, w)
    assert int(overflow) == 0
    assert z_p.dtype == torch.float32 and tri_p.dtype == torch.int32
    np.testing.assert_array_equal(z_p.numpy().view(np.int32),
                                  z_r.numpy().view(np.int32))
    np.testing.assert_array_equal(tri_p.numpy(), tri_r.numpy())


@pytest.mark.parametrize("case", ["small", "mixed_sizes", "depth_ties"])
def test_rasterize_ref_matches_reference(case):
    import jax.numpy as jnp
    from dtrenderer_tpu.ops.raster_ref import rasterize_ref as jref

    screen, faces, h, w, cull = _scene(case)
    setup = _setup(screen, faces, h, w, cull)
    z_r, tri_r = jref(jnp.asarray(setup.coef.numpy()),
                      jnp.asarray(setup.valid.numpy()), h, w)
    z_p, tri_p = rasterize_ref(setup.coef, setup.valid, h, w)
    _assert_matches_reference(z_p.numpy(), tri_p.numpy(), z_r, tri_r, setup)


def test_rasterize_pallas_matches_reference():
    import jax.numpy as jnp
    from dtrenderer_tpu.ops.raster_pallas import rasterize_pallas as jpal

    screen, faces, h, w, cull = _scene("mixed_sizes")
    setup = _setup(screen, faces, h, w, cull)
    z_r, tri_r, ov = jpal(jnp.asarray(setup.coef.numpy()),
                          jnp.asarray(setup.bbox.numpy()),
                          jnp.asarray(setup.valid.numpy()), h, w,
                          tile_h=32, tile_w=128, capacity=128, small_span=8,
                          broad_cap=32)
    assert int(ov) == 0
    z_p, tri_p, _ = prp.rasterize_pallas(setup.coef, setup.bbox, setup.valid,
                                         h, w)
    _assert_matches_reference(z_p.numpy(), tri_p.numpy(), z_r, tri_r, setup)


def test_band_offsets_match_full_frame():
    """tests/test_raster_pallas.py:62 on the port: row bands and a column
    shard (ragged edge tiles) equal the same window of the full frame."""
    screen, faces, h, w, _ = _scene("small")
    setup = _setup(screen, faces, h, w, False)
    z_f, t_f, _ = prp.rasterize_pallas(setup.coef, setup.bbox, setup.valid,
                                       h, w)
    z_rf, t_rf = rasterize_ref(setup.coef, setup.valid, h, w)
    for y0, x0, bh, bw in ((0, 0, 32, w), (32, 0, 32, w), (64, 0, 32, w),
                           (10, 37, 50, 91)):
        z_b, t_b, _ = prp.rasterize_pallas(setup.coef, setup.bbox,
                                           setup.valid, bh, bw, y0, x0)
        z_rb, t_rb = rasterize_ref(setup.coef, setup.valid, bh, bw,
                                   y_offset=y0, x_offset=x0)
        for z, t in ((z_b, t_b), (z_rb, t_rb)):
            np.testing.assert_array_equal(
                z.numpy(), z_f.numpy()[y0:y0 + bh, x0:x0 + bw])
            np.testing.assert_array_equal(
                t.numpy(), t_f.numpy()[y0:y0 + bh, x0:x0 + bw])
    np.testing.assert_array_equal(t_rf.numpy(), t_f.numpy())


def test_rasterize_bins_dispatch_on_cpu_is_the_plain_twin():
    screen, faces, h, w, cull = _scene("small")
    setup = _setup(screen, faces, h, w, cull)
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, h, w)
    before = prp.KERNEL_LAUNCHES
    z_a, t_a = prp.rasterize_bins(setup.coef, bins, h, w)
    z_b, t_b = prp.rasterize_pallas_plain(setup.coef, bins, h, w)
    assert prp.KERNEL_LAUNCHES == before  # the CPU path launches nothing
    assert torch.equal(z_a, z_b) and torch.equal(t_a, t_b)
    with pytest.raises(ValueError, match="coef"):
        prp.rasterize_bins(setup.coef[:, :8].contiguous(), bins, h, w)
    with pytest.raises(ValueError, match="bins"):
        prp.rasterize_bins(setup.coef, bins, h + 32, w)


# ------------------------------------------------------ deferred draw path


DRAW_CASES = [("cube", "gouraud", "bilinear", True),
              ("cube", "flat", "nearest", True),
              ("sphere", "phong", "bilinear", True),
              ("sphere", "none", "nearest", False)]


def _draw(mesh_name, shading, sampling, textured, backend, near_clip=True,
          h=48, w=64):
    mesh = {"cube": lambda: pprim.cube(device=CPU),
            "sphere": lambda: pprim.uv_sphere(10, 14, device=CPU)}[mesh_name]()
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 50.0, device=CPU)
    light = pmake_light((0.4, 0.6, 1.0), 0.15, device=CPU)
    tex = pprim.checkerboard(16, 4, device=CPU) if textured else None
    mdl = pm3.model_matrix((0, 0, -3.5), pm3.mat4mul(
        pm3.rotate_y(0.7, device=CPU), pm3.rotate_x(0.3, device=CPU)),
        device=CPU)
    fb = pfb.clear(pfb.create(h, w, CPU), [0.05, 0.02, 0.1, 1.0])
    out = ppipe.draw_mesh(fb, mesh, mdl, proj, texture=tex, light=light,
                          color=(0.8, 0.6, 0.9, 1.0), shading=shading,
                          sampling_mode=sampling, backend=backend,
                          near_clip=near_clip)
    return out, (mesh, mdl, proj, light, tex, fb)


@pytest.mark.parametrize("mesh_name,shading,sampling,textured", DRAW_CASES)
def test_draw_mesh_backends_bit_equal(mesh_name, shading, sampling,
                                      textured):
    ref, _ = _draw(mesh_name, shading, sampling, textured, "ref")
    assert torch.isfinite(ref.depth).sum() > 300
    for backend in ("pallas", "fused"):
        out, _ = _draw(mesh_name, shading, sampling, textured, backend)
        assert torch.equal(out.depth, ref.depth), backend
        assert torch.equal(out.color, ref.color), backend


@pytest.mark.parametrize("mesh_name,shading,sampling,textured",
                         DRAW_CASES[:3])
def test_draw_mesh_ref_matches_scalar_oracle_bit_exact(mesh_name, shading,
                                                       sampling, textured):
    out, (mesh, mdl, proj, light, tex, fb) = _draw(
        mesh_name, shading, sampling, textured, "ref", near_clip=False)
    h, w = fb.depth.shape
    orc = MeshOracle(mesh.verts.numpy(), mesh.uv.numpy(),
                     mesh.normals.numpy(), mesh.faces.numpy(), mdl.numpy(),
                     pm3.mat4mul(proj, mdl).numpy(), mdl.numpy(),
                     tex.numpy() if textured else np.ones((1, 1, 4),
                                                          np.float32),
                     light.direction.numpy(), float(light.ambient),
                     (0.8, 0.6, 0.9, 1.0), shading, sampling, True, h, w)
    oc, od = orc.render(fb.color.numpy(), fb.depth.numpy())
    np.testing.assert_array_equal(out.depth.numpy().view(np.int32),
                                  od.view(np.int32))
    np.testing.assert_array_equal(out.color.numpy().view(np.int32),
                                  oc.view(np.int32))


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_draw_mesh_deferred_matches_reference(backend):
    """tests/test_raster_pallas.py:91 across the two packages: the
    reference's draw on the same backend, same inputs (convert.py)."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.models import primitives as jprim
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.shading import make_light as jmake_light
    from dtrenderer_tpu.utils import math3d as jm3
    from test_torch_pipeline import _compare_to_reference

    h, w = 64, 128
    mesh, tex = jprim.cube(), jprim.checkerboard(16, 4)
    model = jnp.asarray(jm3.model_matrix((0, 0, -4.0), jm3.rotate_y(0.7)))
    proj = jnp.asarray(jm3.perspective(np.pi / 3, w / h, 0.1, 50.0))
    light = jmake_light((0.4, 0.6, 1.0), 0.15)
    clear = [0.0, 0.0, 0.0, 1.0]
    ref = jax.jit(lambda fb: jpipe.draw_mesh(
        fb, mesh, model, proj, texture=tex, light=light, shading="phong",
        sampling_mode="bilinear", backend=backend))(
            jfb.clear(jfb.create(h, w), jnp.asarray(clear)))

    pmesh, ptex = convert.mesh(mesh, CPU), convert.texture(tex, CPU)
    pmodel, pproj = convert.matrix(model, CPU), convert.matrix(proj, CPU)
    plight = convert.light(light, CPU)
    out, c = ppipe.draw_mesh(pfb.clear(pfb.create(h, w, CPU), clear), pmesh,
                             pmodel, pproj, texture=ptex, light=plight,
                             shading="phong", sampling_mode="bilinear",
                             backend=backend, return_counters=True)
    batch = ppipe.pack_draws([ppipe.DrawSpec(pmesh, pmodel, texture=ptex,
                                             shading="phong")],
                             pproj, plight, "bilinear", w, h)
    assert _compare_to_reference(ref.color, ref.depth, out.color, out.depth,
                                 batch) > 1000
    assert int(c.tris_submitted) == 12  # the mesh's faces, not setup rows
    assert int(c.pixels_shaded) == int(torch.isfinite(out.depth).sum())
    assert int(c.bin_overflow) == 0


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_configs_1_to_3_match_goldens(n, backend):
    """tests/test_goldens.py:32-36 on the port: 160x120, t = 0.6, the port's
    own matrices, packed u8 within +-1 everywhere."""
    from PIL import Image

    spec = pscenes.ALL_CONFIGS[n](160, 120, backend, device=CPU)
    fb0 = pfb.create(120, 160, CPU)
    color, _ = spec.frame(fb0.color, fb0.depth, 0.6)
    golden = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, f"{GOLDENS[n]}.png")), np.uint8)
    diff = np.abs(ppack(color).numpy().astype(int) - golden.astype(int))
    assert diff.max() <= 1, f"{(diff > 1).sum()} channels differ by > 1"


# --------------------------------------------------------------------- gpu


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["small", "mixed_sizes", "depth_ties"])
def test_kernel_matches_plain_twin_on_gpu(case):
    """The CUDA kernel against its plain twin on the card, whole frame and
    shards: z bit-equal, tri equal (run: pytest -m gpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    screen, faces, h, w, cull = _scene(case)
    setup = _setup(screen, faces, h, w, cull)
    coef, bbox, valid = (setup.coef.to(dev), setup.bbox.to(dev),
                         setup.valid.to(dev))
    for y0, x0, bh, bw in ((0, 0, h, w), (24, 37, 40, 91)):
        bins = pbin.bin_triangles(coef, bbox, valid, bh, bw, y0, x0)
        before = prp.KERNEL_LAUNCHES
        z_k, t_k = prp.rasterize_bins(coef, bins, bh, bw, y0, x0)
        assert prp.KERNEL_LAUNCHES == before + 1
        z_p, t_p = prp.rasterize_pallas_plain(coef, bins, bh, bw, y0, x0)
        assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
        assert torch.equal(t_k, t_p)
        z_c, t_c = rasterize_ref(setup.coef, setup.valid, bh, bw,
                                 y_offset=y0, x_offset=x0)
        assert torch.equal(z_k.cpu(), z_c) and torch.equal(t_k.cpu(), t_c)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(stress.CASES))
def test_kernel_matches_plain_twin_on_gpu_stress(case):
    """What the scenes' shapes do not reach on the card: a tile of more
    than 512 triangles (three staging chunks), shared edges through pixel
    centres and along sub-block borders, and shards whose size is no
    multiple of the tile or the sub-block at non-zero offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    corners, h, w = stress.CASES[case]()
    setup = stress.setup(corners, h, w, dev)
    cpu = stress.setup(corners, h, w, CPU)
    for y0, x0, bh, bw in stress.windows(h, w):
        bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, bh, bw,
                                  y0, x0)
        if case == "deep_tile" and (y0, x0) == (0, 0):
            assert int((bins.tile_start[1:] - bins.tile_start[:-1]).max()) \
                > 512
        z_k, t_k = prp.rasterize_bins(setup.coef, bins, bh, bw, y0, x0)
        z_p, t_p = prp.rasterize_pallas_plain(setup.coef, bins, bh, bw, y0,
                                              x0)
        assert int((t_k >= 0).sum()) > 100
        assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
        assert torch.equal(t_k, t_p)
        z_c, t_c = rasterize_ref(cpu.coef, cpu.valid, bh, bw, y_offset=y0,
                                 x_offset=x0)
        assert torch.equal(z_k.cpu(), z_c) and torch.equal(t_k.cpu(), t_c)

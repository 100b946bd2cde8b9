"""The PyTorch port's whole opaque slice (vertex stage -> binning -> fused
raster+shade -> merge) against the JAX reference, the NumPy scalar oracle and
the committed goldens.

Bars (see test_torch_render_fused.py for why f32 values against the
reference's XLA:CPU programs are compared within FMA-contraction noise):
  * NumPy oracle (tests/oracle_pipeline.py, no FMA): depth and colour bit
    for bit;
  * reference draw_meshes / draw_mesh: the same covered pixels, depth within
    1e-4 relative, packed u8 within +-1. A pixel may differ by more only
    where the reference's FMA can move the result by more: two surfaces
    within that depth noise of each other, a pixel centre within rounding of
    a triangle's edge, or a sub-pixel triangle whose edge functions cancel.
    The test checks that the reference's depth at each such pixel is, within
    a rounding bound, that of such a triangle, and that they are rare (at
    most 0.5% of the covered pixels);
  * goldens: packed u8 within +-1 everywhere, the goldens' own bar.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from oracle_pipeline import MeshOracle
from dtrenderer_tpu.models import primitives as jprim
from dtrenderer_tpu.models import scenes as jscenes
from dtrenderer_tpu.ops import fb as jfb
from dtrenderer_tpu.ops import pipeline as jpipe
from dtrenderer_tpu.ops.shading import make_light as jmake_light
from dtrenderer_tpu.utils import math3d as jm3
from dtrenderer_tpu.utils.color import pack_srgb_u8 as jpack
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.debug import FrameCounters
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models import scenes as pscenes
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import geometry as pgeo
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops.shading import make_light as pmake_light
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
Z_REL = 1e-4


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


def _golden(name):
    return np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")),
                      np.uint8)


def _explained(batch, z_ref, y, x):
    """True when the reference's depth at pixel (y, x) is, within rounding,
    the depth there of a triangle that covers the pixel or misses it by a
    rounding-sized margin: a depth near-tie or an edge decision that FMA
    contraction can flip, or a sub-pixel triangle whose edge functions
    cancel. Rounding is bounded per triangle from the magnitudes that the
    FORMULAS.md evaluation cancels, E_k = (A_k px + B_k py) + C_k, with 16
    ulps of slack (2^-20)."""
    c = batch.coef[batch.valid].double().numpy()
    px, py = x + 0.5, y + 0.5
    near = np.ones(len(c), bool)
    mag = np.zeros(len(c))
    for k in range(3):
        a, b, cc = c[:, 3 * k], c[:, 3 * k + 1], c[:, 3 * k + 2]
        s_k = np.abs(a * px) + np.abs(b * py) + np.abs(cc)
        near &= (a * px + b * py) + cc >= -2.0 ** -20 * s_k
        mag += s_k
    err = 2.0 ** -20 * np.abs(c[:, 9]) * mag * np.abs(c[:, 10:13]).max(1)
    _, z, _ = pgeo.coverage_and_depth(batch.coef[batch.valid],
                                      torch.tensor(px), torch.tensor(py))
    dz = np.abs(z.numpy().astype(np.float64) - z_ref)
    return bool(np.any(near & (dz <= Z_REL * z_ref + err)))


def _compare_to_reference(ref_color, ref_depth, color, depth, batch):
    """Same covered pixels; depth within Z_REL and packed u8 within +-1,
    except at pixels _explained by a near-tie or a near-edge decision, which
    must be rare. Returns the covered pixel count."""
    zr, zp = np.asarray(ref_depth), depth.numpy()
    covered = np.isfinite(zr)
    np.testing.assert_array_equal(np.isfinite(zp), covered)
    z_off = covered & ~np.isclose(zp, zr, rtol=Z_REL, atol=0)
    du8 = np.abs(np.asarray(jpack(ref_color)).astype(int)
                 - ppack(color).numpy().astype(int)).max(-1)
    bad = np.argwhere(z_off | (du8 > 1))
    for y, x in bad:
        assert _explained(batch, zr[y, x], y, x), (
            f"pixel {(y, x)}: z {zp[y, x]} vs reference {zr[y, x]}, "
            f"u8 diff {du8[y, x]}, not a near-tie or near-edge flip")
    assert len(bad) <= 5e-3 * covered.sum(), f"{len(bad)} flipped pixels"
    return covered.sum()


# ------------------------------------------------- against the reference


def _config4_draws(h, w, t):
    """The config-4 scene, built by the reference; its matrices go to the
    port through convert.py (jnp.cos and torch.cos may differ in the last
    ulp, and a last-ulp matrix change moves every vertex)."""
    head, cube = jscenes._head_mesh(), jprim.cube()
    sphere = jprim.uv_sphere(24, 32)
    tex, checker = jscenes._head_texture(), jprim.checkerboard(64, 8)
    proj = jnp.asarray(jm3.perspective(np.pi / 3, w / h, 0.1, 100.0))
    light = jmake_light((0.4, 0.6, 1.0), 0.15)
    t = jnp.float32(t)
    draws = [
        (head, jm3.model_matrix((-1.3, 0.1, -3.0), jm3.rotate_y(t), 1.3),
         dict(texture=tex)),
        (cube, jm3.model_matrix((1.5, -0.3, -4.6), jm3.mat4mul(
            jm3.rotate_y(t * 0.8), jm3.rotate_x(0.4))), dict(texture=checker)),
        (sphere, jm3.model_matrix((0.6, 1.0, -5.5), jm3.rotate_y(t * 0.5),
                                  1.1), dict(color=(0.8, 0.5, 0.9, 1.0))),
        (sphere, jm3.model_matrix((-0.4, -1.0, -6.0), jm3.rotate_y(-t), 1.4),
         dict(color=(0.4, 0.9, 0.6, 1.0))),
    ]
    return proj, light, draws


def test_draw_meshes_config4_matches_reference():
    h, w = 120, 160
    proj, light, draws = _config4_draws(h, w, 0.6)
    clear = jnp.asarray([0.03, 0.03, 0.06, 1.0], jnp.float32)
    specs_j = [jpipe.DrawSpec(m, mdl, shading="phong", **kw)
               for m, mdl, kw in draws]

    @jax.jit
    def reference(color, depth):
        # capacity: the reference's default of 512 drops (tile, tri) pairs
        return jpipe.draw_meshes(
            jfb.clear(jfb.Framebuffer(color, depth), clear), proj, specs_j,
            light=light, sampling_mode="bilinear",
            raster_opts=dict(capacity=4096), return_counters=True)

    ref, counters = reference(*jfb.create(h, w))
    assert int(counters.bin_overflow) == 0

    meshes, texs = {}, {}
    specs = []
    for m, mdl, kw in draws:
        kw = dict(kw)
        if "texture" in kw:
            kw["texture"] = texs.setdefault(
                id(kw["texture"]), convert.texture(kw["texture"], CPU))
        mesh = meshes.setdefault(id(m), convert.mesh(m, CPU))
        specs.append(ppipe.DrawSpec(mesh, convert.matrix(mdl, CPU),
                                    shading="phong", **kw))
    plight, pproj = convert.light(light, CPU), convert.matrix(proj, CPU)
    pfb0 = pfb.clear(pfb.create(h, w, CPU), clear.tolist())
    out, pcounters = ppipe.draw_meshes(pfb0, pproj, specs, light=plight,
                                       sampling_mode="bilinear",
                                       return_counters=True)
    batch = ppipe.pack_draws(specs, pproj, plight, "bilinear", w, h)
    covered = _compare_to_reference(ref.color, ref.depth, out.color,
                                    out.depth, batch)
    assert covered > 5000
    assert int(pcounters.bin_overflow) == 0
    assert int(pcounters.tris_submitted) == int(counters.tris_submitted)
    assert int(pcounters.tris_valid) == int(counters.tris_valid)


def test_draw_mesh_config5_matches_reference():
    h, w, n = 128, 256, 2000
    spec = jscenes.make_config5(width=w, height=h, n_tris=n, backend="fused",
                                capacity=1024)
    fb0 = jfb.create(h, w)
    color, depth, overflow = jax.jit(spec.frame, static_argnames=(
        "return_counters",))(fb0.color, fb0.depth, jnp.float32(0.6),
                             return_counters=True)
    assert int(overflow) == 0

    pspec = pscenes.make_config5(width=w, height=h, n_tris=n, device=CPU)
    sub = pspec.submission(0.6)
    # the reference's model matrix (convert: last-ulp cos/sin)
    mdl = convert.matrix(jm3.model_matrix((0, 0, -2.8),
                                          jm3.rotate_y(jnp.float32(0.6) * 0.3)),
                         CPU)
    d = sub.draws[0]
    pf = pfb.clear(pfb.create(h, w, CPU), [0.02, 0.02, 0.04, 1.0])
    out = ppipe.draw_mesh(pf, d.mesh, mdl, sub.view_proj, texture=d.texture,
                          light=sub.light, shading="gouraud",
                          sampling_mode="nearest", backend="fused",
                          near_clip=False)
    d = d.__class__(d.mesh, mdl, texture=d.texture, shading="gouraud")
    batch = ppipe.pack_draws([d], sub.view_proj, sub.light, "nearest", w, h,
                             near_clip=False)
    assert _compare_to_reference(color, depth, out.color, out.depth,
                                 batch) > 500


# ---------------------------------------------- against the scalar oracle


ORACLE_CASES = [("cube", "phong", "bilinear", True),
                ("cube", "flat", "nearest", True),
                ("sphere", "gouraud", "bilinear", False),
                ("sphere", "none", "nearest", True),
                ("fine_sphere", "phong", "nearest", True)]


@pytest.mark.parametrize("mesh_name,shading,sampling,textured", ORACLE_CASES)
def test_draw_mesh_matches_scalar_oracle_bit_exact(mesh_name, shading,
                                                   sampling, textured):
    h, w = 48, 64
    mesh = {"cube": lambda: pprim.cube(device=CPU),
            "sphere": lambda: pprim.uv_sphere(8, 12, device=CPU),
            "fine_sphere": lambda: pprim.uv_sphere(16, 24, device=CPU),
            }[mesh_name]()
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 50.0, device=CPU)
    light = pmake_light((0.4, 0.6, 1.0), 0.15, device=CPU)
    tex = pprim.checkerboard(16, 4, device=CPU) if textured else None
    rot = pm3.mat4mul(pm3.rotate_y(0.7, device=CPU),
                      pm3.rotate_x(0.3, device=CPU))
    mdl = pm3.model_matrix((0, 0, -3.5), rot, device=CPU)
    color = (0.8, 0.6, 0.9, 1.0)
    fb = pfb.clear(pfb.create(h, w, CPU), [0.05, 0.02, 0.1, 1.0])
    out = ppipe.draw_mesh(fb, mesh, mdl, proj, texture=tex, light=light,
                          color=color, shading=shading, sampling_mode=sampling,
                          backend="fused", near_clip=False)
    tex_np = tex.numpy() if textured else np.ones((1, 1, 4), np.float32)
    orc = MeshOracle(mesh.verts.numpy(), mesh.uv.numpy(),
                     mesh.normals.numpy(), mesh.faces.numpy(), mdl.numpy(),
                     pm3.mat4mul(proj, mdl).numpy(), mdl.numpy(), tex_np,
                     light.direction.numpy(), float(light.ambient), color,
                     shading, sampling, True, h, w)
    oc, od = orc.render(fb.color.numpy(), fb.depth.numpy())
    assert np.isfinite(od).sum() > 300
    np.testing.assert_array_equal(out.depth.numpy().view(np.int32),
                                  od.view(np.int32))
    np.testing.assert_array_equal(out.color.numpy().view(np.int32),
                                  oc.view(np.int32))


# ----------------------------------------------------------------- goldens


def _mixed_scene():
    """tests/test_goldens.py::_render_mixed on the port."""
    h, w = 120, 160
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 50.0, device=CPU)
    light = pmake_light((0.4, 0.6, 1.0), 0.15, device=CPU)
    tex = pprim.checkerboard(16, 4, device=CPU)
    fb = pfb.clear(pfb.create(h, w, CPU), [0.04, 0.03, 0.08, 1.0])
    mm = pm3.model_matrix
    draws = [
        ppipe.DrawSpec(pprim.cube(device=CPU),
                       mm((-0.9, 0.0, -4.2), pm3.rotate_y(0.5, device=CPU),
                          device=CPU),
                       texture=tex, shading="gouraud", sampling="nearest"),
        ppipe.DrawSpec(pprim.uv_sphere(10, 14, device=CPU),
                       mm((0.9, 0.1, -4.8), pm3.rotate_y(1.0, device=CPU),
                          device=CPU),
                       texture=tex, shading="phong", sampling="bilinear"),
        ppipe.DrawSpec(pprim.uv_sphere(8, 10, device=CPU),
                       mm((0.0, -0.8, -5.6), pm3.rotate_x(0.3, device=CPU),
                          device=CPU),
                       color=(0.8, 0.5, 0.9, 1.0), shading="flat"),
    ]
    return ppipe.draw_meshes(fb, proj, draws, light=light,
                             sampling_mode="bilinear").color


def _config5_small():
    spec = pscenes.make_config5(width=256, height=128, n_tris=2000,
                                device=CPU)
    fb0 = pfb.create(spec.height, spec.width, CPU)
    return spec.frame(fb0.color, fb0.depth, 0.6)[0]


@pytest.mark.parametrize("name,render", [
    ("config5_1m_tri_4k", _config5_small),
    ("mixed_sampling_shading", _mixed_scene),
])
def test_port_matches_golden(name, render):
    """The port's own scenes (its own matrices) against the goldens, with
    the parameters of tests/test_goldens.py."""
    diff = np.abs(ppack(render()).numpy().astype(int)
                  - _golden(name).astype(int))
    assert diff.max() <= 1, f"{name}: {(diff > 1).sum()} channels > 1"


def test_config4_port_matches_reference_render_without_bin_drops():
    """config4_multimesh_phong.png was rendered by the reference's fused path
    at its default bin capacity (512), which drops 890 (tile, tri) pairs of
    the head at 160x120 and leaves horizontal gaps in it; the port drops
    nothing, so the golden cannot be its bar. The port's own config-4 frame
    (its own matrices) is held instead against the reference's
    `backend="ref"` frame (no binning, nothing dropped) at the goldens' bar,
    near-ties aside as above."""
    spec = jscenes.make_config4(width=160, height=120, backend="ref")
    fb0 = jfb.create(120, 160)
    color, depth = jax.jit(spec.frame)(fb0.color, fb0.depth, jnp.float32(0.6))
    # the golden really is the dropped-pairs image: the ref frame is not it
    assert np.abs(np.asarray(jpack(color)).astype(int)
                  - _golden("config4_multimesh_phong").astype(int)).max() > 1

    pspec = pscenes.make_config4(width=160, height=120, device=CPU)
    pfb0 = pfb.create(120, 160, CPU)
    pcolor, pdepth = pspec.frame(pfb0.color, pfb0.depth, 0.6)
    sub = pspec.submission(0.6)
    batch = ppipe.pack_draws(sub.draws, sub.view_proj, sub.light,
                             sub.sampling_mode, 160, 120)
    assert _compare_to_reference(color, depth, pcolor, pdepth, batch) > 5000


# ------------------------------------------------------ slice boundaries


def test_port_imports_no_jax():
    """Every module of the port imports, a config-1 frame renders on the
    "ref" backend and a translucent draw on both ordered engines, the
    12-px font is baked, a text line and a rectangle are drawn through the
    api, a two-band sharded draw goes through the shared table, and no
    module of JAX, of the JAX package, of PIL, of matplotlib or of
    torch.distributed was loaded by the port."""
    code = (
        "import sys\n"
        "import dtrenderer_tpu_torch\n"
        "import dtrenderer_tpu_torch.convert, dtrenderer_tpu_torch.debug\n"
        "import dtrenderer_tpu_torch.kernels.render_fused\n"
        "import dtrenderer_tpu_torch.kernels.raster_visibility\n"
        "import dtrenderer_tpu_torch.kernels.render_ordered\n"
        "import dtrenderer_tpu_torch.kernels.vertex_pass\n"
        "import dtrenderer_tpu_torch.assets.native\n"
        "import dtrenderer_tpu_torch.assets.obj, dtrenderer_tpu_torch.assets.image\n"
        "import dtrenderer_tpu_torch.models.scenes\n"
        "import dtrenderer_tpu_torch.ops.pipeline, dtrenderer_tpu_torch.ops.sampling\n"
        "import dtrenderer_tpu_torch.ops.raster_ref, dtrenderer_tpu_torch.ops.raster_pallas\n"
        "import dtrenderer_tpu_torch.ops.raster_ordered\n"
        "import dtrenderer_tpu_torch.ops.vertex_batch\n"
        "import dtrenderer_tpu_torch.ops.vertex_graph\n"
        "import dtrenderer_tpu_torch.ops.draw2d, dtrenderer_tpu_torch.ops.text\n"
        "import dtrenderer_tpu_torch.api, dtrenderer_tpu_torch.platform\n"
        "import dtrenderer_tpu_torch.tools.demo, dtrenderer_tpu_torch.tools.cli\n"
        "import dtrenderer_tpu_torch.tools.bake_fonts\n"
        "import dtrenderer_tpu_torch.utils.rng, dtrenderer_tpu_torch.utils.trace\n"
        "import dtrenderer_tpu_torch.utils.checkpoint\n"
        "import dtrenderer_tpu_torch.utils.benchlib\n"
        "import dtrenderer_tpu_torch.tools.dryrun\n"
        "import dtrenderer_tpu_torch.parallel.shard as shard\n"
        "import bench_torch, bench_torch.cells, bench_torch.run\n"
        "import bench_torch.scenes, bench_torch.reference, bench_torch.bounds\n"
        "from dtrenderer_tpu_torch import api\n"
        "from dtrenderer_tpu_torch.assets.font import bake_builtin_font\n"
        "from dtrenderer_tpu_torch.models import primitives, scenes\n"
        "from dtrenderer_tpu_torch.ops import fb, pipeline\n"
        "from dtrenderer_tpu_torch.utils import math3d as m3\n"
        "spec = scenes.make_config4(64, 32, device='cpu')\n"
        "spec.frame(*fb.create(32, 64, 'cpu'), 0.5)\n"
        "spec = scenes.make_config1(64, 32, 'ref', device='cpu')\n"
        "spec.frame(*fb.create(32, 64, 'cpu'), 0.5)\n"
        "proj = m3.perspective(1.0, 2.0, 0.1, 10.0, device='cpu')\n"
        "mdl = m3.translate((0, 0, -3.0), device='cpu')\n"
        "for engine in ('tile', 'scan'):\n"
        "    pipeline.draw_mesh_ordered(fb.create(32, 64, 'cpu'),\n"
        "        primitives.uv_sphere(6, 8, device='cpu'), mdl, proj,\n"
        "        color=(1, 0.5, 0.2, 0.5), engine=engine)\n"
        "font = bake_builtin_font(12, device='cpu')\n"
        "st = api.clear(api.new_state(64, 32, device='cpu'))\n"
        "st = api.render_text(st, 'no jax', (2, 2), font=font)\n"
        "st = api.render_rectangle(st, (4, 20), (30, 28), (1, 0, 0, 1),\n"
        "    api.transform2d(rotation=0.3, device='cpu'))\n"
        "assert api.finish_frame(st)[..., 0].max() == 255\n"
        "dmesh = shard.make_mesh(rows=2, devices=['cpu'])\n"
        "ball = primitives.uv_sphere(6, 8, device='cpu')\n"
        "out = shard.draw_mesh_sharded(shard.create_sharded_fb(32, 64, dmesh),\n"
        "    ball, mdl, proj, dmesh, backend='fused',\n"
        "    raster_opts=dict(row_bands=2))\n"
        "one = pipeline.draw_mesh(fb.create(32, 64, 'cpu'), ball, mdl, proj,\n"
        "    backend='fused')\n"
        "assert shard.gather_fb(out).color.equal(one.color) and one.color.any()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'PIL', 'matplotlib'))\n"
        "             or m == 'dtrenderer_tpu' or m.startswith('dtrenderer_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # the band split is one controller over a mesh of devices: no process
    # group (torch itself may load torch.distributed, so read the sources)
    pkg = os.path.join(REPO, "dtrenderer_tpu_torch")
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel builds, copies
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert "torch.distributed" not in f.read(), name


def _tiny_fb():
    return pfb.create(16, 16, CPU)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_unported_backends_raise(backend):
    """What stays unported of backend="ref"/"pallas" (both render:
    test_torch_raster.py) are the reference's TPU binning/kernel knobs: any
    raster_opts key raises, and leaves the framebuffer untouched."""
    proj = pm3.perspective(1.0, 1.0, 0.1, 10.0, device=CPU)
    cube, eye = pprim.cube(device=CPU), pm3.identity(device=CPU)
    fb = _tiny_fb()
    for opts in (dict(capacity=128), dict(tile_h=16, tile_w=256)):
        with pytest.raises(NotImplementedError, match=next(iter(opts))):
            ppipe.draw_mesh(fb, cube, eye, proj, backend=backend,
                            raster_opts=opts)
    assert torch.isinf(fb.depth).all()


def test_translucent_draws_and_raster_opts_raise():
    """Translucent draws render (test_torch_ordered.py); the reference's
    TPU knobs raise: raster_opts on the fused path and draw_mesh_ordered,
    ordered_opts on draw_meshes."""
    proj = pm3.perspective(1.0, 1.0, 0.1, 10.0, device=CPU)
    cube = pprim.cube(device=CPU)
    eye = pm3.identity(device=CPU)
    ppipe.draw_meshes(_tiny_fb(), proj,
                      [ppipe.DrawSpec(cube, eye),
                       ppipe.DrawSpec(cube, eye, color=(1, 1, 1, 0.5))])
    with pytest.raises(NotImplementedError, match="small_span"):
        ppipe.draw_meshes(_tiny_fb(), proj,
                          [ppipe.DrawSpec(cube, eye, translucent=True)],
                          ordered_opts=dict(small_span=8))
    with pytest.raises(NotImplementedError, match="capacity"):
        ppipe.draw_mesh(_tiny_fb(), cube, eye, proj, backend="fused",
                        raster_opts=dict(capacity=128))
    with pytest.raises(NotImplementedError, match="tile_h"):
        ppipe.draw_mesh_ordered(_tiny_fb(), cube, eye, proj,
                                raster_opts=dict(tile_h=16))
    with pytest.raises(ValueError, match="sampling"):
        ppipe.draw_mesh(_tiny_fb(), cube, eye, proj, backend="fused",
                        sampling_mode="trilinear")


@pytest.mark.parametrize("call,match", [
    (lambda fb, m, e, p: ppipe.draw_mesh(fb, m, e, p, backend="cuda"),
     "backend"),
    (lambda fb, m, e, p: ppipe.draw_mesh_ordered(fb, m, e, p, engine="fast"),
     "engine"),
    (lambda fb, m, e, p: ppipe.draw_meshes(
        fb, p, [ppipe.DrawSpec(m, e, translucent=True)],
        ordered_engine="fast"), "engine"),
    (lambda fb, m, e, p: ppipe.draw_mesh_ordered(
        fb, m, e, p, sampling_mode="trilinear"), "sampling"),
])
def test_unknown_backend_engine_or_mode_raises(call, match):
    proj = pm3.perspective(1.0, 1.0, 0.1, 10.0, device=CPU)
    with pytest.raises(ValueError, match=match):
        call(_tiny_fb(), pprim.cube(device=CPU), pm3.identity(device=CPU),
             proj)


def test_frame_counters_of_two_draws_merge():
    proj = pm3.perspective(np.pi / 3, 4 / 3, 0.1, 50.0, device=CPU)
    cube = pprim.cube(device=CPU)
    fb = pfb.create(48, 64, CPU)
    total = FrameCounters.zero(CPU)
    for x, z in ((-0.8, -4.0), (0.6, -3.5)):
        mdl = pm3.model_matrix((x, 0.0, z), pm3.rotate_y(0.5, device=CPU),
                               device=CPU)
        prev = fb.depth
        fb, c = ppipe.draw_mesh(fb, cube, mdl, proj, backend="fused",
                                return_counters=True)
        assert int(c.pixels_shaded) == int((fb.depth < prev).sum()) > 0
        assert int(c.tris_submitted) == 2 * cube.num_tris  # near clip: 1 -> 2
        total = total.merge(c)
    assert int(total.bin_overflow) == 0
    assert 0 < int(total.tris_valid) <= int(total.tris_submitted) == 48
    assert int(total.pixels_shaded) >= int(torch.isfinite(fb.depth).sum())


def test_bands_of_a_frame_equal_the_whole_frame():
    """A frame rendered as row/column shards (frame_height/frame_width and
    the shard's y/x offset, as parallel/shard.py renders bands) equals the
    unsharded frame bit for bit."""
    h, w = 64, 128
    sub = pscenes.make_config4(width=w, height=h, device=CPU).submission(0.4)

    def render(y0, x0, bh, bw):
        fb = pfb.clear(pfb.create(bh, bw, CPU), [0.1, 0.0, 0.2, 1.0])
        out = ppipe.draw_meshes(fb, sub.view_proj, sub.draws, light=sub.light,
                                sampling_mode=sub.sampling_mode,
                                frame_height=h, frame_width=w, y_offset=y0,
                                x_offset=x0)
        return out.color.numpy(), out.depth.numpy()

    color, depth = render(0, 0, h, w)
    assert np.isfinite(depth).sum() > 2000
    for y0, x0, bh, bw in ((0, 0, 24, w), (24, 0, 40, w), (0, 48, h, 80),
                           (40, 100, 24, 28)):
        c, z = render(y0, x0, bh, bw)
        np.testing.assert_array_equal(c, color[y0:y0 + bh, x0:x0 + bw])
        np.testing.assert_array_equal(z, depth[y0:y0 + bh, x0:x0 + bw])

"""The port's band split of a frame over a mesh of devices
(dtrenderer_tpu_torch/parallel/shard.py, the cross-band binning of
ops/binning.py and the band keys of raster_opts), on a mesh of `cpu` cells.
Mirrors tests/test_shard.py.

Two bars:
  * against the port's own single-device render: depth and colour bit for
    bit, whatever the mesh, the backend and the way of binning (the winner of
    a pixel is (min z, min id) whatever tile list it came from, and a pixel
    belongs to one band);
  * against the JAX package's `shard.*` render of the same scene (meshes,
    textures and matrices made on the host by the port and handed over as
    arrays) on conftest's 8 virtual CPU devices (jitted: the reference's
    eager shard_map compiles op by op and takes a minute a call): the same
    covered pixels, depth within 1e-4 relative, packed u8 within +-1 with
    zero outliers. XLA:CPU contracts FMAs, so f32 values differ by that
    noise (ROADMAP.md queue 3).

The reference's shard_budget tests have no mirror: the port's bins have no
budget and drop nothing (ROADMAP.md "Leave behind").

JAX is imported inside the tests that compare with it, so the `gpu` tests
run on a machine without it (python -m pytest --noconftest -m gpu
tests/test_torch_shard.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.parallel import shard as pshard
from dtrenderer_tpu_torch.utils import math3d as pm3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

CPU = torch.device("cpu")
Z_REL = 1e-4
CLEAR = [0.1, 0.0, 0.0, 1.0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(**kw):
    return pshard.make_mesh(devices=[CPU], **kw)


def assert_bits(got: pfb.Framebuffer, want: pfb.Framebuffer, tag=""):
    for name in ("depth", "color"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, (tag, name, a.shape, b.shape)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
            f"{tag}: {name} differs at "
            f"{int((a.view(torch.int32) != b.view(torch.int32)).sum())}")


def reference():
    """The JAX package, and helpers to hand it the port's scene data."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.models.mesh import Mesh as JMesh
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.parallel import shard as jshard
    from dtrenderer_tpu.utils.color import pack_srgb_u8 as jpack

    def arr(t, dtype=jnp.float32):
        return jnp.asarray(t.numpy(), dtype)

    def mesh(m):
        return JMesh(verts=arr(m.verts), uv=arr(m.uv), normals=arr(m.normals),
                     faces=arr(m.faces, jnp.int32))

    assert len(jax.devices()) == 8, "conftest provides 8 virtual devices"
    return SimpleNamespace(jax=jax, jnp=jnp, fb=jfb, pipe=jpipe,
                           shard=jshard, pack=jpack, arr=arr, mesh=mesh)


def assert_near_reference(ref, ref_fb, got: pfb.Framebuffer):
    """The stated bar against the JAX package's render."""
    zr, zp = np.asarray(ref_fb.depth), got.depth.numpy()
    covered = np.isfinite(zr)
    assert covered.any()
    np.testing.assert_array_equal(np.isfinite(zp), covered)
    np.testing.assert_allclose(zp[covered], zr[covered], rtol=Z_REL, atol=0)
    du8 = np.abs(np.asarray(ref.pack(ref_fb.color)).astype(int)
                 - ppack(got.color).numpy().astype(int))
    assert du8.max() <= 1


# ------------------------------------------------------------ the cube scene


class Cube:
    """tests/test_shard.py's cube scene."""
    h, w = 64, 128

    def __init__(self):
        self.mesh = pprim.cube(device=CPU)
        self.tex = pprim.checkerboard(16, 4, device=CPU)
        self.proj = pm3.perspective(np.pi / 3, self.w / self.h, 0.1, 50.0,
                                    device=CPU)

    def model(self, angle):
        return pm3.model_matrix((0, 0, -4.0),
                                pm3.rotate_y(float(angle), device=CPU),
                                device=CPU)

    def single(self, angle, backend="ref", clear=None):
        fb = pfb.create(self.h, self.w, CPU)
        if clear is not None:
            fb = pfb.clear(fb, clear)
        return ppipe.draw_mesh(fb, self.mesh, self.model(angle), self.proj,
                               texture=self.tex, shading="gouraud",
                               backend=backend)


@pytest.fixture(scope="module")
def cube():
    return Cube()


@pytest.mark.parametrize("backend", ["ref", "pallas", "fused"])
def test_row_sharded_matches_single(cube, backend):
    """rows = 8 over a framebuffer with a clear colour: 8-row bands, half a
    tile each."""
    dmesh = cpu_mesh(frames=1, rows=8)
    assert dmesh.shape == {"frames": 1, "rows": 8, "cols": 1}
    whole = pfb.clear(pfb.create(cube.h, cube.w, CPU), CLEAR)
    multi = pshard.draw_mesh_sharded(
        whole, cube.mesh, cube.model(0.6), cube.proj, dmesh, texture=cube.tex,
        shading="gouraud", backend=backend)
    assert isinstance(multi, pshard.ShardedFramebuffer)
    assert multi.frames[0][3][0].depth.shape == (8, cube.w)
    got = pshard.gather_fb(multi)
    assert_bits(got, cube.single(0.6, backend, CLEAR), backend)
    assert pshard.gather_image(multi).tobytes() == got.color.numpy().tobytes()

    if backend == "ref":
        ref = reference()
        jmesh = ref.shard.make_mesh(frames=1, rows=8)
        fb8 = ref.shard.create_sharded_fb(cube.h, cube.w, jmesh)
        fb8 = ref.fb.Framebuffer(
            color=fb8.color + ref.jnp.asarray(CLEAR, ref.jnp.float32),
            depth=fb8.depth)
        out = ref.jax.jit(lambda f: ref.shard.draw_mesh_sharded(
            f, ref.mesh(cube.mesh), ref.arr(cube.model(0.6)),
            ref.arr(cube.proj), jmesh, texture=ref.arr(cube.tex),
            shading="gouraud"))(fb8)
        assert_near_reference(ref, out, got)


@pytest.mark.parametrize("frames,rows,cols", [(2, 4, 1), (2, 2, 2)],
                         ids=["frames2_rows4", "frames2_rows2_cols2"])
def test_frames_x_rows_mesh(cube, frames, rows, cols):
    """A batch of frames over "frames", each cut over rows (x cols): the
    five-parameter band function on the rows-only mesh, the six-parameter
    one (x0) with columns. The per-frame argument is the frame's model
    matrix, so both packages get the same bits."""
    angles = [0.3, 1.1]
    models = torch.stack([cube.model(a) for a in angles])
    dmesh = cpu_mesh(frames=frames, rows=rows, cols=cols)

    def draw(band_fb, model, y0, fh, fw, x0):
        assert band_fb.depth.shape == (cube.h // rows, cube.w // cols)
        return ppipe.draw_mesh(
            band_fb, cube.mesh, model, cube.proj, texture=cube.tex,
            shading="gouraud", frame_height=fh, frame_width=fw, y_offset=y0,
            x_offset=x0)

    if cols == 1:
        band_fn = lambda fb, model, y0, fh, fw: draw(fb, model, y0, fh, fw, 0)
    else:
        band_fn = draw
    fb = pshard.create_sharded_fb(cube.h, cube.w, dmesh, batch=2)
    out = pshard.render_frames_sharded(band_fn, fb, dmesh, models)
    got = pshard.gather_fb(out)
    assert got.color.shape == (2, cube.h, cube.w, 4)
    for i, ang in enumerate(angles):
        assert_bits(pfb.Framebuffer(got.color[i], got.depth[i]),
                    cube.single(ang), f"frame {i}")
    assert not torch.equal(got.color[0], got.color[1])

    ref = reference()
    jmesh = ref.shard.make_mesh(frames=frames, rows=rows, cols=cols)
    jcube, jtex, jproj = (ref.mesh(cube.mesh), ref.arr(cube.tex),
                          ref.arr(cube.proj))

    def jband(band_fb, model, y0, fh, fw, x0=0):
        return ref.pipe.draw_mesh(
            band_fb, jcube, model, jproj, texture=jtex, shading="gouraud",
            frame_height=fh, frame_width=fw, y_offset=y0, x_offset=x0)

    jfb2 = ref.shard.create_sharded_fb(cube.h, cube.w, jmesh, batch=2)
    out = ref.jax.jit(lambda f, a: ref.shard.render_frames_sharded(
        jband, f, jmesh, a))(jfb2, ref.arr(models))
    for i in range(2):
        assert_near_reference(
            ref, ref.fb.Framebuffer(out.color[i], out.depth[i]),
            pfb.Framebuffer(got.color[i], got.depth[i]))


def test_2d_rows_x_cols_sharded_matches_single(cube):
    dmesh = cpu_mesh(frames=1, rows=4, cols=2)
    assert dmesh.shape["rows"] == 4 and dmesh.shape["cols"] == 2
    for backend in ("ref", "pallas", "fused"):
        multi = pshard.draw_mesh_sharded(
            pshard.create_sharded_fb(cube.h, cube.w, dmesh), cube.mesh,
            cube.model(0.6), cube.proj, dmesh, texture=cube.tex,
            shading="gouraud", backend=backend)
        got = pshard.gather_fb(multi)
        assert_bits(got, cube.single(0.6, backend), backend)

    ref = reference()
    jmesh = ref.shard.make_mesh(frames=1, rows=4, cols=2)
    out = ref.jax.jit(lambda f: ref.shard.draw_mesh_sharded(
        f, ref.mesh(cube.mesh), ref.arr(cube.model(0.6)), ref.arr(cube.proj),
        jmesh, texture=ref.arr(cube.tex), shading="gouraud", backend="fused",
        raster_opts=dict(tile_h=8, capacity=128)))(
            ref.shard.create_sharded_fb(cube.h, cube.w, jmesh))
    assert_near_reference(ref, out, got)


# ---------------------------------------------------- the ordered sphere


def test_ordered_translucent_sharded_matches_single():
    """A translucent sphere through draw_mesh_ordered_sharded over 8 bands
    equals the single-device ordered render: submission order within a band
    is the global order, and each band blends over its own slice of the
    incoming framebuffer (a clear colour and a depth plane that hides part
    of the sphere, not a cleared one)."""
    h, w, rows = 128, 128, 8
    col = (0.8, 0.5, 0.9, 0.5)
    mesh = pprim.uv_sphere(12, 16, device=CPU)
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=CPU)
    mdl = pm3.model_matrix((0, 0, -2.6), pm3.rotate_y(0.4, device=CPU), 1.3,
                           device=CPU)
    dmesh = cpu_mesh(frames=1, rows=rows)
    kw = dict(color=col, shading="gouraud", engine="tile")

    out = pshard.draw_mesh_ordered_sharded(
        pshard.create_sharded_fb(h, w, dmesh), mesh, mdl, proj, dmesh, **kw)
    got = pshard.gather_fb(out)
    single, counters = ppipe.draw_mesh_ordered(
        pfb.create(h, w, CPU), mesh, mdl, proj, return_counters=True, **kw)
    assert int(counters.bin_overflow) == 0
    assert_bits(got, single)
    assert not torch.equal(got.color, pfb.create(h, w, CPU).color)

    # over an incoming framebuffer: the left half lies in front of the sphere
    fb_in = pfb.clear(pfb.create(h, w, CPU), CLEAR)
    depth_in = fb_in.depth.clone()
    depth_in[:, : w // 2] = 0.0
    fb_in = pfb.Framebuffer(fb_in.color, depth_in)
    out2, c2 = pshard.draw_mesh_ordered_sharded(
        fb_in, mesh, mdl, proj, dmesh, return_counters=True, **kw)
    single2, c1 = ppipe.draw_mesh_ordered(fb_in, mesh, mdl, proj,
                                          return_counters=True, **kw)
    got2 = pshard.gather_fb(out2)
    assert_bits(got2, single2)
    assert torch.equal(got2.color[:, : w // 2], fb_in.color[:, : w // 2])
    assert [int(x) for x in c2] == [int(x) for x in c1]
    out3 = pshard.draw_mesh_ordered_sharded(
        fb_in, mesh, mdl, proj, dmesh, color=col, shading="gouraud",
        engine="scan")
    assert_bits(pshard.gather_fb(out3), single2, "scan")

    ref = reference()
    jdmesh = ref.shard.make_mesh(frames=1, rows=rows)
    out = ref.jax.jit(lambda f: ref.shard.draw_mesh_ordered_sharded(
        f, ref.mesh(mesh), ref.arr(mdl), ref.arr(proj), device_mesh=jdmesh,
        color=col, shading="gouraud", engine="tile",
        raster_opts=dict(tile_h=16, capacity=512)))(
            ref.shard.create_sharded_fb(h, w, jdmesh))
    assert_near_reference(ref, out, got)


# ------------------------------------------------------------- the soup


class Soup:
    """tests/test_shard.py's 4,000-triangle soup."""
    n, rows = 4_000, 8

    def __init__(self, h=128, w=128):
        self.h, self.w = h, w
        self.soup = pprim.random_triangle_soup(self.n, rng_seed=13,
                                               extent=1.4, device=CPU)
        self.proj = pm3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=CPU)
        self.mdl = pm3.model_matrix((0, 0, -2.6),
                                    pm3.rotate_y(0.3, device=CPU), device=CPU)
        self.kw = dict(shading="gouraud", near_clip=False, backend="fused")

    def single(self, **kw):
        return ppipe.draw_mesh(pfb.create(self.h, self.w, CPU), self.soup,
                               self.mdl, self.proj, **self.kw, **kw)

    def sharded(self, dmesh, opts, **kw):
        return pshard.draw_mesh_sharded(
            pshard.create_sharded_fb(self.h, self.w, dmesh), self.soup,
            self.mdl, self.proj, dmesh, raster_opts=opts, **self.kw, **kw)


WAYS = {
    "per_band": None,
    "shared": dict(row_bands=8),
    "shared_off": dict(row_bands=8, band_shared=False),
    "distributed": dict(row_bands=8, band_distributed=True),
}


@pytest.fixture(scope="module")
def soup():
    return Soup()


@pytest.fixture(scope="module")
def soup_single(soup):
    return soup.single(return_counters=True)


@pytest.mark.parametrize("way", sorted(WAYS))
def test_shared_crossband_binning_sharded_matches_single(soup, soup_single,
                                                         way):
    """Per band, shared table and distributed exchange over 8 bands: each
    bit-equal to the single launch, with the frame's counters (triangles
    counted once, pixels summed over the bands)."""
    single, c1 = soup_single
    out, c8 = soup.sharded(cpu_mesh(rows=8), WAYS[way], return_counters=True)
    assert_bits(pshard.gather_fb(out), single, way)
    assert [int(x) for x in c8] == [int(x) for x in c1]
    assert int(c1.tris_submitted) == soup.n and int(c1.pixels_shaded) > 0
    assert int(c8.bin_overflow) == 0


def test_shared_crossband_binning_near_reference(soup, soup_single):
    """The port's banded render against the JAX package's shared-table
    sharded render of the same soup, at the bar of test_torch_pipeline.py:
    sub-pixel triangles make near-ties and near-edge decisions that XLA:CPU's
    FMA contraction flips, so a pixel beyond depth 1e-4 relative or u8 +-1
    must be explained as one, and they must be rare."""
    from test_torch_pipeline import _compare_to_reference

    ref = reference()
    jdmesh = ref.shard.make_mesh(frames=1, rows=soup.rows)
    opts = dict(tile_h=8, capacity=512, small_span=8, flat_bins=True,
                pair_budget=4 * soup.n, row_bands=soup.rows)
    out = ref.jax.jit(lambda f: ref.shard.draw_mesh_sharded(
        f, ref.mesh(soup.soup), ref.arr(soup.mdl), ref.arr(soup.proj),
        device_mesh=jdmesh, shading="gouraud", near_clip=False,
        backend="fused", raster_opts=opts))(
            ref.shard.create_sharded_fb(soup.h, soup.w, jdmesh))
    batch = ppipe.pack_draws(
        [ppipe.DrawSpec(soup.soup, soup.mdl, shading="gouraud")], soup.proj,
        ppipe.make_light(device=CPU), "nearest", soup.w, soup.h,
        near_clip=False)
    got = soup_single[0]
    assert _compare_to_reference(out.color, out.depth, got.color, got.depth,
                                 batch) > 500


@pytest.mark.parametrize("way", sorted(WAYS))
def test_band_height_not_a_multiple_of_the_tile(way):
    """136 rows in 8 bands of 17: every band's last tile row is one pixel
    row, the banded grid has 8 x 2 tile rows and the frame's own grid 9.
    Through the mesh, and through draw_mesh on the whole framebuffer."""
    s = Soup(h=136, w=112)
    single = s.single()
    assert_bits(pshard.gather_fb(s.sharded(cpu_mesh(rows=8), WAYS[way])),
                single, way)
    if WAYS[way] is not None:
        whole, counters = s.single(raster_opts=WAYS[way],
                                   return_counters=True)
        assert_bits(whole, single, f"draw_mesh {way}")
        assert int(counters.tris_submitted) == s.n


def test_draw_mesh_band_index_renders_one_band(soup, soup_single):
    """raster_opts band_index on a band's own framebuffer, as a caller's
    band function passes it: the band of the whole frame, through the
    shared table's window and through the band's own binning."""
    single = soup_single[0]
    bh = soup.h // 8
    for shared in (True, False):
        for b in (0, 3, 7):
            band = ppipe.draw_mesh(
                pfb.create(bh, soup.w, CPU), soup.soup, soup.mdl, soup.proj,
                frame_height=soup.h, frame_width=soup.w, y_offset=b * bh,
                raster_opts=dict(row_bands=8, band_index=b,
                                 band_shared=shared), **soup.kw)
            rows = slice(b * bh, (b + 1) * bh)
            assert_bits(band, pfb.Framebuffer(single.color[rows],
                                              single.depth[rows]), f"band {b}")


def test_draw_meshes_row_bands_with_a_translucent_draw(cube):
    """draw_meshes: the band keys apply to the opaque runs, a translucent
    draw between them goes through the ordered draw as before."""
    sphere = pprim.uv_sphere(8, 12, device=CPU)
    draws = [
        ppipe.DrawSpec(cube.mesh, cube.model(0.6), texture=cube.tex),
        ppipe.DrawSpec(sphere, cube.model(0.2), color=(0.8, 0.5, 0.9, 0.5)),
        ppipe.DrawSpec(cube.mesh, cube.model(1.4), texture=cube.tex,
                       shading="phong"),
    ]
    fb = pfb.clear(pfb.create(cube.h, cube.w, CPU), CLEAR)
    want, c1 = ppipe.draw_meshes(fb, cube.proj, draws, return_counters=True)
    for opts in (dict(row_bands=4), dict(row_bands=4, band_distributed=True),
                 dict(row_bands=2, band_shared=False)):
        got, c2 = ppipe.draw_meshes(fb, cube.proj, draws, raster_opts=opts,
                                    return_counters=True)
        assert_bits(got, want, str(opts))
        assert [int(x) for x in c2] == [int(x) for x in c1]


# --------------------------------------------------- mesh and framebuffer


def test_mesh_cycles_devices_and_framebuffer_round_trip():
    a, b = torch.device("cpu"), torch.device("meta")
    dmesh = pshard.make_mesh(frames=2, rows=3, cols=1, devices=[a, b])
    assert dmesh.devices.shape == (2, 3, 1)
    assert [str(d) for d in dmesh.devices.reshape(-1)] == [
        "cpu", "meta", "cpu", "meta", "cpu", "meta"]
    assert dmesh.distinct(0) == [a, b] and dmesh.distinct(1) == [b, a]
    assert pshard.make_mesh(devices=[a] * 8).shape["rows"] == 8
    assert pshard.make_mesh(frames=2, cols=2, devices=[a] * 8).shape == {
        "frames": 2, "rows": 2, "cols": 2}

    rng = np.random.default_rng(5)
    dmesh = cpu_mesh(frames=2, rows=2, cols=3)
    for batch in (None, 4):
        lead = () if batch is None else (batch,)
        fb = pfb.Framebuffer(
            torch.tensor(rng.random(lead + (10, 12, 4), np.float32)),
            torch.tensor(rng.random(lead + (10, 12), np.float32)))
        cut = pshard.shard_fb(fb, dmesh)
        assert cut.batch == batch and len(cut.frames) == (batch or 1)
        assert cut.frames[0][1][2].color.shape == (5, 4, 4)
        assert cut.frames[0][1][2].color.is_contiguous()
        assert [cut.group(i) for i in range(batch or 1)] == (
            [0] if batch is None else [0, 0, 1, 1])
        back = pshard.gather_fb(cut)
        assert torch.equal(back.color, fb.color)
        assert torch.equal(back.depth, fb.depth)
    empty = pshard.gather_fb(pshard.create_sharded_fb(10, 12, dmesh, batch=2))
    assert empty.color.shape == (2, 10, 12, 4) and not empty.color.any()
    assert torch.isinf(empty.depth).all()


def test_scene_inputs_move_once_per_distinct_device(cube, monkeypatch):
    """8 cells on one device: one vertex stage, eight rasters."""
    calls = {"stage": 0, "raster": 0}
    stage, raster = ppipe.stage_draw_mesh, ppipe.raster_staged

    def counting_stage(*a, **kw):
        calls["stage"] += 1
        return stage(*a, **kw)

    def counting_raster(*a, **kw):
        calls["raster"] += 1
        return raster(*a, **kw)

    monkeypatch.setattr(ppipe, "stage_draw_mesh", counting_stage)
    monkeypatch.setattr(ppipe, "raster_staged", counting_raster)
    dmesh = cpu_mesh(rows=8)
    pshard.draw_mesh_sharded(
        pshard.create_sharded_fb(cube.h, cube.w, dmesh), cube.mesh,
        cube.model(0.6), cube.proj, dmesh, texture=cube.tex, backend="fused")
    assert calls == {"stage": 1, "raster": 8}


def test_a_scene_tensor_keeps_one_copy_per_device_while_it_lives():
    """_to copies a tensor from another device into the same copy on every
    call (refreshed), so a graph keyed on its address recurs; the copy goes
    with the tensor. ("meta" stands in for another card.)"""
    import gc

    meta = torch.device("meta")
    verts = torch.arange(12.0).reshape(4, 3)
    first = pshard._to(meta, (verts, {"m": verts}))
    again = pshard._to(meta, [verts])
    assert first[0] is first[1]["m"] is again[0]
    assert first[0].device == meta and first[0].shape == verts.shape
    assert pshard._to(CPU, verts) is verts  # already there: no copy
    key = (id(verts), str(meta))
    assert key in pshard._MIRRORS
    del verts, first, again
    gc.collect()
    assert key not in pshard._MIRRORS


# ------------------------------------------------------- what must raise


def test_sharded_misuse_raises(cube, soup):
    dmesh8, dmesh42 = cpu_mesh(rows=8), cpu_mesh(rows=4, cols=2)
    with pytest.raises(ValueError, match="not divisible by 8 bands"):
        pshard.create_sharded_fb(60, 128, dmesh8)
    with pytest.raises(ValueError, match="not divisible by 2 columns"):
        pshard.create_sharded_fb(64, 127, dmesh42)
    with pytest.raises(ValueError, match="frame groups"):
        pshard.create_sharded_fb(64, 128, cpu_mesh(frames=2, rows=2), batch=3)
    with pytest.raises(ValueError, match="must equal the mesh rows axis"):
        soup.sharded(dmesh8, dict(row_bands=4))
    with pytest.raises(ValueError, match="shards rows only"):
        soup.sharded(dmesh42, dict(row_bands=4))
    with pytest.raises(ValueError, match="band_index is the mesh's"):
        soup.sharded(dmesh8, dict(row_bands=8, band_index=2))
    with pytest.raises(ValueError, match="another mesh"):
        pshard.draw_mesh_sharded(
            pshard.create_sharded_fb(soup.h, soup.w, dmesh8), soup.soup,
            soup.mdl, soup.proj, cpu_mesh(rows=8))
    batched = pshard.create_sharded_fb(64, 128, dmesh8, batch=1)
    with pytest.raises(ValueError, match="render_frames_sharded"):
        pshard.draw_mesh_sharded(batched, cube.mesh, cube.model(0.6),
                                 cube.proj, dmesh8)
    with pytest.raises(ValueError, match="batched"):
        pshard.render_frames_sharded(
            lambda *a: a[0], pshard.create_sharded_fb(64, 128, dmesh8),
            dmesh8, np.zeros(1, np.float32))

    bh = soup.h // 8
    band = pfb.create(bh, soup.w, CPU)
    draw = lambda fb, opts, **kw: ppipe.draw_mesh(
        fb, soup.soup, soup.mdl, soup.proj, raster_opts=opts, **soup.kw, **kw)
    with pytest.raises(ValueError, match="frame_height"):
        draw(band, dict(row_bands=8, band_index=1))  # frame_height = band_h
    with pytest.raises(ValueError, match="cannot run the exchange alone"):
        draw(band, dict(row_bands=8, band_index=1, band_distributed=True),
             frame_height=soup.h, y_offset=bh)
    with pytest.raises(ValueError, match="must divide"):
        draw(pfb.create(soup.h, soup.w, CPU), dict(row_bands=7))


@pytest.mark.parametrize("key", ["shard_budget", "pair_budget", "flat_bins",
                                 "capacity", "tile_h", "band_axis"])
def test_other_raster_opts_keys_still_raise(soup, key):
    """Only the four band keys are taken, and only on backend "fused"."""
    dmesh = cpu_mesh(rows=8)
    with pytest.raises(NotImplementedError, match=key):
        soup.sharded(dmesh, {"row_bands": 8, key: 1})
    with pytest.raises(NotImplementedError, match=key):
        soup.single(raster_opts={key: 1})
    for backend in ("ref", "pallas"):
        with pytest.raises(NotImplementedError, match="row_bands"):
            ppipe.draw_mesh(pfb.create(soup.h, soup.w, CPU), soup.soup,
                            soup.mdl, soup.proj, backend=backend,
                            raster_opts=dict(row_bands=8))
    with pytest.raises(NotImplementedError, match="row_bands"):
        ppipe.draw_mesh_ordered(pfb.create(soup.h, soup.w, CPU), soup.soup,
                                soup.mdl, soup.proj,
                                raster_opts=dict(row_bands=8))
    with pytest.raises(NotImplementedError, match=key):
        ppipe.draw_meshes(pfb.create(soup.h, soup.w, CPU), soup.proj,
                          [ppipe.DrawSpec(soup.soup, soup.mdl)],
                          raster_opts={key: 1})
    # without row_bands > 1 the other band keys mean nothing, as in the
    # reference
    assert ppipe.band_opts(dict(band_index=3, band_distributed=True)) == (
        ppipe.BandOpts())


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_band_paths_on_the_card():
    """The band paths on the card (run: pytest -m gpu): 8 bands of 17 rows
    over every CUDA device, cycled; each way of binning bit-equal to the
    single launch, with eight K1 launches; K2 and K3 eight launches each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dtrenderer_tpu_torch.ops import raster_ordered, raster_pallas

    dev = torch.device("cuda", 0)
    h, w, n = 136, 256, 4000
    soup = pprim.random_triangle_soup(n, rng_seed=13, extent=1.4, device=dev)
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=dev)
    mdl = pm3.model_matrix((0, 0, -2.6), pm3.rotate_y(0.3, device=dev),
                           device=dev)
    dmesh = pshard.make_mesh(rows=8)
    kw = dict(shading="gouraud", near_clip=False)
    single = ppipe.draw_mesh(pfb.create(h, w, dev), soup, mdl, proj,
                             backend="fused", **kw)
    for way, opts in WAYS.items():
        before = prf.KERNEL_LAUNCHES
        out = pshard.draw_mesh_sharded(
            pshard.create_sharded_fb(h, w, dmesh), soup, mdl, proj, dmesh,
            backend="fused", raster_opts=opts, **kw)
        assert prf.KERNEL_LAUNCHES - before == 8
        assert_bits(pfb.Framebuffer(*(t.cpu() for t in
                                      pshard.gather_fb(out, dev))),
                    pfb.Framebuffer(*(t.cpu() for t in single)), way)
    before = raster_pallas.KERNEL_LAUNCHES
    out = pshard.draw_mesh_sharded(pshard.create_sharded_fb(h, w, dmesh),
                                   soup, mdl, proj, dmesh, backend="pallas",
                                   **kw)
    assert raster_pallas.KERNEL_LAUNCHES - before == 8
    assert_bits(pfb.Framebuffer(*(t.cpu() for t in pshard.gather_fb(out))),
                pfb.Framebuffer(*(t.cpu() for t in single)), "pallas")
    okw = dict(color=(0.8, 0.5, 0.9, 0.5), **kw)
    before = raster_ordered.KERNEL_LAUNCHES
    out = pshard.draw_mesh_ordered_sharded(
        pshard.create_sharded_fb(h, w, dmesh), soup, mdl, proj, dmesh, **okw)
    assert raster_ordered.KERNEL_LAUNCHES - before == 8
    want = ppipe.draw_mesh_ordered(pfb.create(h, w, dev), soup, mdl, proj,
                                   **okw)
    assert_bits(pfb.Framebuffer(*(t.cpu() for t in pshard.gather_fb(out))),
                pfb.Framebuffer(*(t.cpu() for t in want)), "ordered")


@pytest.mark.gpu
def test_cli_and_dryrun_on_the_card(tmp_path):
    """The band paths through the tools on the card: the CLI's 4 x 2 split
    of config 4 (tiles of 54 x 240) equals its unbanded render, and the dry
    run's scenes pass over 8 cells of the machine's cards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dtrenderer_tpu_torch.tools import cli, dryrun

    base = ["--scene", "4", "--w", "480", "--h", "216", "--save-npy"]
    whole, band = str(tmp_path / "whole.png"), str(tmp_path / "band.png")
    cli.main(base + ["--out", whole])
    cli.main(base + ["--rows", "4", "--cols", "2", "--out", band])
    assert np.load(whole + ".npy").tobytes() == np.load(
        band + ".npy").tobytes()
    dryrun.main(["--devices", "8"])

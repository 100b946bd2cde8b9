"""The batched vertex stage (dtrenderer_tpu_torch/ops/vertex_batch.py) and
its CUDA graph (ops/vertex_graph.py).

Bars:
  * `pipeline.pack_draws` (one batched pass over all draws of a run) equals
    the per-draw composition that it replaces, written out here
    (`per_draw`: prepare_draw + pack_payload per draw, torch.cat, and
    make_texture_lut): coef, bbox, valid, payload and LUT bit for bit
    (f32 compared as int32 bit patterns), over mixed shading modes,
    textured and untextured draws, a texture used twice, near-clipped
    triangles, backface culling on and off, mvps and normal matrices given,
    and a run of one draw;
  * each draw's rows of the batch of config 4 and of the fill scene at a
    small size against the JAX package's `prepare_draw` for that draw
    (eager, op by op): valid and bbox exactly, coef and corner attributes
    within the FMA noise that tests/test_torch_pipeline.py allows (1e-4
    relative), texture metadata and flags exactly;
  * the pass dispatches as many ops for a run of two draws as of six;
  * `vertex_graph.submission_key` changes with a draw's mode, sampling,
    flags, mesh shape and address, texture, frame size, culling and near
    clip, and not with the values of matrices, light or colours;
  * `vertex_graph.Keys` (plain Python) captures every key that a frame
    repeats, whatever their number, drops a key that stops recurring and
    keeps a rarer one, and keeps only a bounded number of first sightings,
    with no entry; a `Stamp` raises once its key has replayed again;
  * on the card (`gpu`): replays bit-equal to the eager pass at three times,
    a mesh changed in place seen by the next replay, two identical opaque
    runs around a translucent draw, the band routes, whose streams read
    a replayed batch, bit-equal to the single launch, and a staged draw
    that raises once the same draw is staged again. JAX is imported only
    inside the tests that compare with it, so the `gpu` tests run without
    it (python -m pytest --noconftest -m gpu tests/test_torch_vertex_batch.py).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models.mesh import Mesh
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops import vertex_batch, vertex_graph
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3

CPU = torch.device("cpu")
W, H = 96, 64
Z_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def per_draw(draws, view_proj, light, sampling_mode, w, h,
             cull_backfaces=True, near_clip=True, mvps=None):
    """The vertex stage and packing one draw at a time, as pack_draws did
    before its batched pass: DrawBatch fields (coef, bbox, valid, payload,
    tex_lut)."""
    white = pprim.white_texture(device=light.direction.device)
    lut, meta = prf.make_texture_lut(
        [d.texture if d.texture is not None else white for d in draws])
    parts = []
    for i, (d, m) in enumerate(zip(draws, meta)):
        mvp = mvps[i] if mvps is not None else pm3.mat4mul(view_proj,
                                                           d.model)
        normal_mat = d.normal_mat if d.normal_mat is not None else d.model
        setup, attrs10 = ppipe.prepare_draw(
            d.mesh, d.model, view_proj, mvp, normal_mat, light, d.color,
            d.shading, w, h, cull_backfaces, near_clip)
        flags = prf.pack_flags(d.shading == "phong",
                               (d.sampling or sampling_mode) == "bilinear")
        parts.append((setup.coef, setup.bbox, setup.valid,
                      prf.pack_payload(attrs10, m, flags)))
    return [torch.cat(x) for x in zip(*parts)] + [lut]


def assert_same_batch(got, want):
    for name, g, r in zip(ppipe.DrawBatch._fields, got, want):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), (
            f"{name} differs at {int((g != r).sum())} elements")


def _assets(device):
    """(cube, sphere, plane, checker, gradient) of _scene."""
    return (pprim.cube(device=device), pprim.uv_sphere(6, 8, device=device),
            pprim.plane(1.5, device=device),
            pprim.checkerboard(16, 4, device=device),
            pprim.gradient_texture(8, device=device))


def _scene(device, t=0.6, assets=None):
    """Draws of every mode: a flat textured cube, a Gouraud sphere with a
    tensor colour, a Phong cube with the cube's texture again and its own
    sampling, an unshaded textured plane, a Phong plane through the near
    plane, an untextured Gouraud cube; matrices at time t, meshes and
    textures from `assets` (new ones by default)."""
    def mm(pos, angle, s=1.0):
        return pm3.model_matrix(pos, pm3.rotate_y(angle, device=device), s,
                                device=device)

    cube, sphere, plane, checker, grad = assets or _assets(device)
    proj = pm3.perspective(np.pi / 3, W / H, 0.1, 50.0, device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    draws = [
        ppipe.DrawSpec(cube, mm((-1.2, 0.3, -4.0), t), texture=checker,
                       shading="flat", color=(0.9, 0.8, 0.7, 1.0)),
        ppipe.DrawSpec(sphere, mm((0.8, -0.4, -3.5), -t, 0.8),
                       color=torch.tensor([0.3, 0.9, 0.5, 1.0],
                                          device=device)),
        ppipe.DrawSpec(cube, mm((1.4, 0.8, -5.0), 0.5 * t), texture=checker,
                       shading="phong", sampling="nearest"),
        ppipe.DrawSpec(plane, mm((0.0, -1.0, -3.0), 0.2 + t), texture=grad,
                       shading="none"),
        ppipe.DrawSpec(plane, mm((0.2, -0.5, -0.5), t, 3.0),
                       shading="phong", color=(0.6, 0.6, 1.0, 1.0)),
        ppipe.DrawSpec(cube, mm((-0.5, -0.8, -2.5), 1.3 * t, 0.4),
                       shading="gouraud", color=(1.0, 0.5, 0.2, 1.0)),
    ]
    return proj, light, draws


def _normals_given(draws, device):
    for d in draws[1::2]:
        d.normal_mat = pm3.mat4mul(d.model, pm3.scale((1.0, 2.0, 0.5),
                                                      device=device))
    return draws


CASES = {
    "all_modes": dict(),
    "no_culling": dict(cull_backfaces=False),
    "no_near_clip": dict(near_clip=False),
    "mvps_given": dict(mvps=True),
    "normal_mats_given": dict(normals=True),
    "one_draw": dict(pick=[1]),
    "one_draw_near_clipped": dict(pick=[4]),
    "one_mode_many_draws": dict(pick=[2, 4]),
    "untextured_only": dict(pick=[1, 5, 4]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_pass_equals_the_per_draw_composition(case):
    opts = dict(CASES[case])
    proj, light, draws = _scene(CPU)
    if "pick" in opts:
        draws = [draws[i] for i in opts.pop("pick")]
    if opts.pop("normals", False):
        draws = _normals_given(draws, CPU)
    if opts.pop("mvps", False):
        opts["mvps"] = [pm3.mat4mul(proj, pm3.mat4mul(
            d.model, pm3.translate((0.0, 0.05 * i, 0.0), device=CPU)))
            for i, d in enumerate(draws)]
    kw = {"cull_backfaces": True, "near_clip": True, **opts}
    got = ppipe.pack_draws(draws, proj, light, "bilinear", W, H, **kw)
    want = per_draw(draws, proj, light, "bilinear", W, H, **kw)
    assert_same_batch(got, want)
    assert int(got.valid.sum()) > 0
    if case == "all_modes":  # some triangles clip to a quad
        assert int(want[2].reshape(-1, 2)[:, 1].sum()) > 0


class _CountOps(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_the_pass_runs_as_many_ops_for_any_number_of_draws():
    """One pass per run: the ops the host dispatches for the pass do not
    grow with the draws of a mode (the per-draw loop ran them per draw)."""
    proj, light, draws = _scene(CPU)
    cube, sphere = draws[2].mesh, draws[1].mesh
    counts = []
    for n in (2, 3, 6):
        run = [ppipe.DrawSpec(cube if i % 2 else sphere, d.model,
                              shading="phong", texture=draws[0].texture)
               for i, d in enumerate((draws * 2)[:n])]
        plan = vertex_batch.plan_run(run, "bilinear", W, H, True, True,
                                     False, CPU)
        vec = vertex_batch.frame_vector(plan, run, proj, light)
        with _CountOps() as ops:
            vertex_batch.run_pass(plan, vec, run)
        counts.append(ops.n)
    assert counts[0] == counts[1] == counts[2], counts


def test_unknown_shading_mode_raises():
    proj, light, draws = _scene(CPU)
    draws[2].shading = "toon"
    with pytest.raises(ValueError, match="shading"):
        ppipe.pack_draws(draws, proj, light, "nearest", W, H)


# ------------------------------------------------- against the reference


def _held_to_reference(jdraws, proj, light, sampling_mode, w, h):
    """pack_draws of the port (inputs converted from the reference's
    arrays) against the reference's prepare_draw per draw."""
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.utils import math3d as jm3

    meshes, texs, specs = {}, {}, []
    for m, mdl, kw in jdraws:
        kw = dict(kw)
        if "texture" in kw:
            kw["texture"] = texs.setdefault(
                id(kw["texture"]), convert.texture(kw["texture"], CPU))
        specs.append(ppipe.DrawSpec(
            meshes.setdefault(id(m), convert.mesh(m, CPU)),
            convert.matrix(mdl, CPU), shading="phong", **kw))
    plight, pproj = convert.light(light, CPU), convert.matrix(proj, CPU)
    batch = ppipe.pack_draws(specs, pproj, plight, sampling_mode, w, h)

    at, checked = 0, 0
    for (m, mdl, kw), spec in zip(jdraws, specs):
        setup, attrs = jpipe.prepare_draw(
            m, mdl, proj, jm3.mat4mul(proj, mdl), mdl, light,
            kw.get("color", (1.0, 1.0, 1.0, 1.0)), "phong", w, h)
        rows = slice(at, at + setup.coef.shape[0])
        at = rows.stop
        np.testing.assert_array_equal(batch.valid[rows].numpy(),
                                      np.asarray(setup.valid))
        np.testing.assert_array_equal(batch.bbox[rows].numpy(),
                                      np.asarray(setup.bbox))
        v = np.asarray(setup.valid)
        np.testing.assert_allclose(batch.coef[rows].numpy()[v],
                                   np.asarray(setup.coef)[v], rtol=Z_REL,
                                   atol=1e-6)
        ref_attrs = np.asarray(attrs).reshape(-1, 30)
        np.testing.assert_allclose(batch.payload[rows, 4:].numpy()[v],
                                   ref_attrs[v], rtol=Z_REL, atol=1e-6)
        head = batch.payload[rows, :4].numpy()
        tw, th = (kw["texture"].shape[1], kw["texture"].shape[0]) \
            if "texture" in kw else (1, 1)
        assert (head[:, 1:] == [tw, th, 3.0]).all()  # phong + bilinear
        checked += int(v.sum())
    assert at == batch.coef.shape[0] and checked > 0
    return batch


def test_config4_rows_against_reference_prepare_draw():
    from test_torch_pipeline import _config4_draws

    h, w = 60, 80
    proj, light, draws = _config4_draws(h, w, 0.6)
    batch = _held_to_reference(draws, proj, light, "bilinear", w, h)
    assert batch.tex_lut.shape[0] == (
        draws[0][2]["texture"].shape[0] * draws[0][2]["texture"].shape[1]
        + 64 * 64 + 1)


def test_fill_scene_rows_against_reference_prepare_draw():
    import jax.numpy as jnp
    from dtrenderer_tpu.models import primitives as jprim
    from dtrenderer_tpu.ops.shading import make_light as jmake_light
    from dtrenderer_tpu.utils import math3d as jm3

    h, w = 48, 80
    sphere, tex = jprim.uv_sphere(8, 10), jprim.checkerboard(16, 4)
    proj = jnp.asarray(jm3.perspective(np.pi / 3, w / h, 0.1, 100.0))
    light = jmake_light((0.4, 0.6, 1.0), 0.15)
    draws = [(sphere, jnp.asarray(jm3.model_matrix(
        (x, y, -3.2), jm3.rotate_y(0.3 * (x + y)), 1.05)), dict(texture=tex))
        for x in (-1.2, 0.0, 1.2) for y in (-0.7, 0.7)]
    batch = _held_to_reference(draws, proj, light, "bilinear", w, h)
    assert batch.tex_lut.shape[0] == 16 * 16  # one texture, stored once


# ------------------------------------------------------------ the key


def _key(draws, proj, light, **kw):
    args = dict(sampling_mode="bilinear", frame_w=W, frame_h=H)
    args.update(kw)
    return vertex_graph.submission_key(draws, proj, light, **args)


def test_key_ignores_values_and_sees_what_changes_the_pass():
    proj, light, draws = _scene(CPU, 0.6)
    base = _key(draws, proj, light)
    proj2, light2, draws2 = _scene(CPU, 0.9)
    for d, d2 in zip(draws, draws2):  # same meshes and textures
        d2.mesh, d2.texture = d.mesh, d.texture
    draws2[0].color = (0.1, 0.2, 0.3, 1.0)
    draws2[1].color = torch.tensor([0.5, 0.5, 0.5, 1.0])
    light2 = make_light((0.0, 1.0, 0.0), 0.4, device=CPU)
    assert _key(draws2, proj2 * 1.5, light2) == base

    def changed(mutate=None, **kw):
        _, _, ds = _scene(CPU, 0.6)
        for d, d0 in zip(ds, draws):
            d.mesh, d.texture = d0.mesh, d0.texture
        if mutate:
            mutate(ds)
        return _key(ds, proj, light, **kw) != base

    assert changed(lambda ds: setattr(ds[0], "shading", "gouraud"))
    assert changed(lambda ds: setattr(ds[3], "sampling", "nearest"))
    assert changed(lambda ds: setattr(ds[2], "normal_mat", ds[2].model))
    assert changed(lambda ds: setattr(ds[0], "color",
                                      torch.ones(4)))  # host -> tensor
    assert changed(lambda ds: setattr(ds[1], "mesh",
                                      pprim.uv_sphere(6, 9, device=CPU)))
    copy = Mesh(*(t.clone() for t in draws[0].mesh))
    assert changed(lambda ds: setattr(ds[0], "mesh", copy))  # address
    assert changed(lambda ds: setattr(ds[1], "texture", draws[0].texture))
    assert changed(lambda ds: setattr(ds[2], "texture",
                                      draws[0].texture.clone()))
    assert changed(frame_w=W + 16)
    assert changed(frame_h=H - 16)
    assert changed(cull_backfaces=False)
    assert changed(near_clip=False)
    assert changed(mvps=[proj] * len(draws))
    assert changed(lambda ds: ds.pop())


# --------------------------------------------- which keys are captured


def _frames(keys, frames):
    """Sight each frame's keys in order; per frame, per key: "eager",
    "capture" or "replay"."""
    out = []
    for frame in frames:
        row = []
        for k in frame:
            e = keys.sight(k)
            row.append("eager" if e is None else
                       "replay" if e.graph is not None else "capture")
            if e is not None and e.graph is None:
                e.graph = object()  # what vertex_graph.pack would capture
        out.append(row)
    return out


@pytest.mark.parametrize("n_keys", [1, 5, 40])
def test_every_key_a_frame_repeats_is_captured_whatever_their_number(n_keys):
    keys = vertex_graph.Keys()
    frame = [("draw", i) for i in range(n_keys)]
    got = _frames(keys, [frame] * 4)
    assert got == [["eager"] * n_keys, ["capture"] * n_keys,
                   ["replay"] * n_keys, ["replay"] * n_keys]
    assert len(keys.live) == n_keys and not keys.first


def test_a_key_that_stops_recurring_is_dropped_and_a_rarer_one_stays():
    keys = vertex_graph.Keys()
    live = []
    for i in range(9):  # A and B every frame, C in frames 0-2, E every other
        frame = ["A", "B"] + (["C"] if i < 3 else []) + (["E"] if i % 2 == 0
                                                        else [])
        _frames(keys, [frame])
        live.append(set(keys.live))
    assert live[2] == {"A", "B", "C", "E"}
    assert live[-1] == {"A", "B", "E"}
    assert all(len(x) <= 4 for x in live)


def test_first_sightings_keep_no_entry_and_are_bounded():
    keys = vertex_graph.Keys(seen_max=8)
    assert _frames(keys, [[i for i in range(100)]]) == [["eager"] * 100]
    assert not keys.live and list(keys.first) == list(range(92, 100))
    assert _frames(keys, [[0, 99]]) == [["eager", "capture"]]


def test_a_stamp_raises_once_its_key_replays_again():
    entry = vertex_graph._Entry(1, 1)
    stamp = vertex_graph.Stamp(entry)
    stamp.check()
    entry.replays += 1
    with pytest.raises(RuntimeError, match="overwritten by a later replay"):
        stamp.check()
    assert vertex_graph.stamp(ppipe.DrawBatch(*[torch.zeros(1)] * 5)) is None


# ------------------------------------------------------------ on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _packed(draws, proj, light, **kw):
    batch = ppipe.pack_draws(draws, proj, light, "bilinear", W, H, **kw)
    return ppipe.DrawBatch(*(t.clone() for t in batch))


@pytest.mark.gpu
def test_replays_equal_the_eager_pass_on_the_card():
    dev = _card()
    vertex_graph.reset()
    assets = _assets(dev)
    for t in (0.5, 0.5, 0.3, 0.7, 0.3):
        proj, light, draws = _scene(dev, t, assets)
        got = _packed(draws, proj, light)
        want = vertex_batch.pack(draws, proj, light, "bilinear", W, H)
        assert_same_batch(got, want)
    assert (vertex_graph.EAGER, vertex_graph.CAPTURES,
            vertex_graph.REPLAYS) == (1, 1, 4)


@pytest.mark.gpu
def test_a_mesh_changed_in_place_is_seen_by_the_next_replay():
    dev = _card()
    vertex_graph.reset()
    proj, light, draws = _scene(dev)
    for _ in range(3):
        _packed(draws, proj, light)
    draws[1].mesh.verts.mul_(1.25)
    draws[0].texture.mul_(0.5)
    got = _packed(draws, proj, light)
    assert vertex_graph.REPLAYS == 3
    assert_same_batch(got, vertex_batch.pack(draws, proj, light, "bilinear",
                                              W, H))


@pytest.mark.gpu
def test_two_identical_opaque_runs_around_a_translucent_draw():
    dev = _card()
    vertex_graph.reset()
    proj, light, draws = _scene(dev)
    trans = ppipe.DrawSpec(draws[1].mesh, draws[1].model,
                           color=(0.8, 0.5, 0.9, 0.6), shading="phong")
    seq = draws[:3] + [trans] + draws[:3]
    fb0 = pfb.create(H, W, dev)
    frames = [ppipe.draw_meshes(fb0, proj, seq, light=light) for _ in range(3)]
    assert vertex_graph.CAPTURES >= 1 and vertex_graph.REPLAYS >= 3
    for fb in frames[1:]:
        assert torch.equal(fb.color, frames[0].color)
        assert torch.equal(fb.depth, frames[0].depth)


@pytest.mark.gpu
def test_band_streams_read_replayed_batches_bit_equal():
    """parallel/shard.py reads a staged batch on the cells' streams: the
    join when a draw returns orders the next replay after them, and
    render_frames_sharded, whose band jobs replay on their own streams,
    has each replay wait for the previous one's stream."""
    from dtrenderer_tpu_torch.parallel import shard as pshard

    dev = _card()
    vertex_graph.reset()
    h, w = 136, 256
    soup = pprim.random_triangle_soup(3000, rng_seed=5, extent=1.4,
                                      device=dev)
    proj = pm3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=dev)
    dmesh = pshard.make_mesh(rows=8)
    kw = dict(shading="gouraud", near_clip=False, backend="fused")

    def model(t):
        return pm3.model_matrix((0, 0, -2.6), pm3.rotate_y(t, device=dev),
                                device=dev)

    for t in (0.3, 0.5, 0.7, 0.3):
        single = ppipe.draw_mesh(pfb.create(h, w, dev), soup, model(t), proj,
                                 **kw)
        for opts in (None, dict(row_bands=8)):
            out = pshard.gather_fb(pshard.draw_mesh_sharded(
                pshard.create_sharded_fb(h, w, dmesh), soup, model(t), proj,
                dmesh, raster_opts=opts, **kw), dev)
            assert torch.equal(out.depth, single.depth)
            assert torch.equal(out.color, single.color)

    def band_fn(band_fb, t, y0, fh, fw, x0):
        out = ppipe.draw_mesh(band_fb, soup, model(float(t)), proj,
                              y_offset=y0, x_offset=x0, frame_height=fh,
                              frame_width=fw, **kw)
        return out.color, out.depth

    times = torch.tensor([0.3, 0.9, 0.6])
    got = pshard.gather_fb(pshard.render_frames_sharded(
        band_fn, pshard.create_sharded_fb(h, w, dmesh, batch=3), dmesh,
        times), dev)
    for i, t in enumerate(times.tolist()):
        want = ppipe.draw_mesh(pfb.create(h, w, dev), soup, model(t), proj,
                               **kw)
        assert torch.equal(got.depth[i], want.depth)
        assert torch.equal(got.color[i], want.color)
    assert vertex_graph.REPLAYS > 8


@pytest.mark.gpu
def test_a_staged_draw_raises_once_the_same_draw_is_staged_again():
    """stage_draw_mesh at t = 0.3, then at t = 0.7 of the same draw: the
    second replay overwrites the first's batch, so rastering the first
    raises; the second rasters bit-equal to the eager pass, and a draw
    rastered before the next staging is drawn as staged."""
    dev = _card()
    vertex_graph.reset()
    proj, light, draws = _scene(dev)
    d = draws[0]

    def model(t):
        return pm3.model_matrix((-1.2, 0.3, -4.0), pm3.rotate_y(t, device=dev),
                                device=dev)

    def stage(t):
        return ppipe.stage_draw_mesh(
            dev, d.mesh, model(t), proj, H, W, texture=d.texture, light=light,
            color=d.color, shading=d.shading, backend="fused")

    def eager(t):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vertex_graph, "pack", vertex_batch.pack)
            return ppipe.raster_staged(pfb.create(H, W, dev), stage(t))

    for t in (0.5, 0.5):  # first sighting eager, second captured
        ppipe.raster_staged(pfb.create(H, W, dev), stage(t))
    early, late = stage(0.3), stage(0.7)
    assert early.stamp is not None and late.stamp is not None
    with pytest.raises(RuntimeError, match="overwritten by a later replay"):
        ppipe.raster_staged(pfb.create(H, W, dev), early)
    for t, staged in ((0.7, lambda: late), (0.3, lambda: stage(0.3))):
        got = ppipe.raster_staged(pfb.create(H, W, dev), staged())
        want = eager(t)
        assert torch.equal(got.depth, want.depth)
        assert torch.equal(got.color, want.color)

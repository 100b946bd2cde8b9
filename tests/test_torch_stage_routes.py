"""The vertex stage of draw_mesh's "pallas" and "ref" backends and of
draw_mesh_ordered's "scan" engine: one eager batched pass
(ops/vertex_batch.py; on the card one launch of csrc/vertex_pass.cu) in
place of the per-draw prepare_draw.

Bars:
  * stage_draw_mesh / stage_draw_mesh_ordered give setup.coef, setup.bbox,
    setup.valid and attrs10 bit-equal (NaN at the same places) to
    prepare_draw on the same inputs, over every shading mode with and
    without the near clip and culling, a given mvp, a given normal matrix
    and every case of models/edge_cases.py; attrs10 is a view of the
    batch's payload (row stride 34), which shade_deferred hands the kernel
    without a copy; the counters' submitted triangles are the mesh's faces
    on "pallas" and "ref" and the setup rows on "scan";
  * a mesh the pass does not read raises on every route: there is no
    fallback to prepare_draw;
  * a "pallas" and a "ref" draw at 160x120 through both packages (the JAX
    one jitted, its "pallas" route in Pallas interpret mode, as its own
    tests run it): the same covered pixels, depth within 1e-4 relative and
    packed u8 within +-1 but for rare FMA-contraction flips
    (test_torch_pipeline.py's bar);
  * on the card (`gpu`): the staged fields bit-equal to prepare_draw's on
    the card and to the CPU's, one vertex kernel launch per staging, and
    no vertex graph sighting (python -m pytest --noconftest -m gpu
    tests/test_torch_stage_routes.py).
"""

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models.mesh import Mesh
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import vertex_batch as pvb
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3

CPU = torch.device("cpu")
H, W = 48, 64
ROUTES = ("pallas", "ref", "scan")
SHADINGS = ("flat", "gouraud", "phong", "none")
COLOR = (0.9, 0.8, 0.7, 0.9)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool. Values do not depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage(route, device, mesh, model, view_proj, h, w, **kw):
    if route == "scan":
        return ppipe.stage_draw_mesh_ordered(device, mesh, model, view_proj,
                                             h, w, engine="scan", **kw)
    return ppipe.stage_draw_mesh(device, mesh, model, view_proj, h, w,
                                 backend=route, **kw)


def assert_bits(tag, got, want):
    """Same dtype, shape and bits; a float NaN may be any NaN, at the same
    places."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, tag
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), f"{tag}: NaN places"
        got = torch.where(nan, 0, got.contiguous().view(torch.int32))
        want = torch.where(nan, 0, want.contiguous().view(torch.int32))
    assert torch.equal(got, want), (
        f"{tag}: differs at {int((got != want).sum())} elements")


def assert_staged_like_prepare_draw(tag, staged, mesh, model, view_proj,
                                    light, color, shading, h, w, cull=True,
                                    near_clip=True, mvp=None,
                                    normal_mat=None):
    setup, attrs10 = ppipe.prepare_draw(
        mesh, model, view_proj,
        pm3.mat4mul(view_proj, model) if mvp is None else mvp,
        model if normal_mat is None else normal_mat, light, color, shading,
        w, h, cull, near_clip)
    for name in ("coef", "bbox", "valid"):
        assert_bits(f"{tag} {name}", getattr(staged.setup, name),
                    getattr(setup, name))
    assert_bits(f"{tag} attrs10", staged.attrs10, attrs10)
    return setup


def sphere_inputs(device):
    proj = pm3.perspective(1.0, W / H, 0.1, 20.0, device=device)
    model = pm3.model_matrix((0.2, -0.1, -3.2), pm3.mat4mul(
        pm3.rotate_y(0.7, device=device), pm3.rotate_x(0.4, device=device)),
        device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    return pprim.uv_sphere(10, 14, device=device), model, proj, light


def near_inputs(device):
    """A cube that reaches behind the camera, so that the near clip cuts
    some faces into two triangles (seen with culling off)."""
    proj = pm3.perspective(1.2, W / H, 0.5, 20.0, device=device)
    model = pm3.model_matrix((0.3, 0.1, -2.0), pm3.rotate_y(
        0.5, device=device), 1.5, device=device)
    light = make_light((0.2, 0.9, 0.6), 0.2, device=device)
    return pprim.cube(device=device), model, proj, light


# ------------------------------------------------------ against prepare_draw


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shading", SHADINGS)
def test_staging_equals_prepare_draw(route, shading):
    for make in (sphere_inputs, near_inputs):
        mesh, model, proj, light = make(CPU)
        for near_clip in (True, False):
            for cull in (True, False):
                tag = (f"{route} {shading} {make.__name__} near_clip="
                       f"{near_clip} cull={cull}")
                staged = stage(route, CPU, mesh, model, proj, H, W,
                               light=light, color=COLOR, shading=shading,
                               cull_backfaces=cull, near_clip=near_clip)
                setup = assert_staged_like_prepare_draw(
                    tag, staged, mesh, model, proj, light, COLOR, shading,
                    H, W, cull, near_clip)
                rows = setup.coef.shape[0]
                assert rows == mesh.faces.shape[0] * (2 if near_clip else 1)
                assert staged.n_submitted == (
                    rows if route == "scan" else mesh.faces.shape[0]), tag
                assert staged.attrs10.stride() == (34, 10, 1), tag
                assert staged.stamp is None and staged.batch is None
                if near_clip and not cull and make is near_inputs:
                    assert int(setup.valid[1::2].sum()) > 0, tag
        assert int(setup.valid.sum()) > 0


@pytest.mark.parametrize("route", ROUTES)
def test_a_given_mvp_and_normal_matrix(route):
    mesh, model, proj, light = sphere_inputs(CPU)
    mvp = pm3.mat4mul(proj, pm3.mat4mul(
        pm3.model_matrix((0.0, 0.3, -0.4), device=CPU), model))
    normal_mat = pm3.mat4mul(pm3.rotate_x(0.9, device=CPU), model)
    for shading in ("gouraud", "phong", "flat"):
        for kw in (dict(mvp=mvp), dict(normal_mat=normal_mat),
                   dict(mvp=mvp, normal_mat=normal_mat)):
            staged = stage(route, CPU, mesh, model, proj, H, W, light=light,
                           color=COLOR, shading=shading, **kw)
            assert_staged_like_prepare_draw(
                f"{route} {shading} {sorted(kw)}", staged, mesh, model,
                proj, light, COLOR, shading, H, W, **kw)


def edge_case_stagings(route, device):
    """(tag, staged, prepare_draw's arguments) per draw of every edge case,
    staged on `route` on `device`."""
    light = make_light(*ec.LIGHT, device=device)
    for name, make in ec.CASES.items():
        case = make()
        view_proj = torch.from_numpy(case.view_proj).to(device)
        for i, s in enumerate(ec.draw_specs(case, device)):
            staged = stage(route, device, s.mesh, s.model, view_proj,
                           case.height, case.width, texture=s.texture,
                           light=light, color=s.color, shading=s.shading,
                           sampling_mode=s.sampling,
                           cull_backfaces=case.cull_backfaces,
                           near_clip=case.near_clip)
            yield (f"{route} edge case {name} draw {i}", staged,
                   (s.mesh, s.model, view_proj, light, s.color, s.shading,
                    case.height, case.width, case.cull_backfaces,
                    case.near_clip))


@pytest.mark.parametrize("route", ROUTES)
def test_edge_cases_stage_like_prepare_draw(route):
    n = 0
    for tag, staged, args in edge_case_stagings(route, CPU):
        assert_staged_like_prepare_draw(tag, staged, *args)
        n += 1
    assert n == sum(len(make().draws) for make in ec.CASES.values())


def test_the_staged_attrs_reach_the_kernel_without_a_copy():
    """shade_deferred hands the kernel attrs10 as it is (a view of row
    stride 34) and a contiguous [T, 3, 10] as it is; another layout is
    copied into rows of 30 contiguous channels."""
    mesh, model, proj, light = sphere_inputs(CPU)
    staged = stage("pallas", CPU, mesh, model, proj, H, W, light=light)
    a = staged.attrs10
    T = a.shape[0]
    assert ppipe._attrs_rows(a, T, CPU) is a
    c = a.contiguous()
    assert ppipe._attrs_rows(c, T, CPU) is c
    t = c.transpose(1, 2).contiguous().transpose(1, 2)  # strides (30, 1, 3)
    got = ppipe._attrs_rows(t, T, CPU)
    assert got.stride() == (30, 10, 1) and torch.equal(got, a)
    with pytest.raises(ValueError, match="attrs"):
        ppipe._attrs_rows(a[:, :, :9], T, CPU)


@pytest.mark.parametrize("route", ROUTES)
def test_a_mesh_the_pass_does_not_read_raises(route):
    """f32 verts, uv and normals and i64 or i32 faces are required on every
    route; prepare_draw would have taken these, and no route falls back to
    it."""
    mesh, model, proj, light = sphere_inputs(CPU)
    for bad in (mesh._replace(verts=mesh.verts.double()),
                mesh._replace(faces=mesh.faces.to(torch.int16))):
        with pytest.raises(ValueError, match="mesh"):
            stage(route, CPU, bad, model, proj, H, W, light=light)
    faces32 = Mesh(mesh.verts, mesh.uv, mesh.normals,
                   mesh.faces.to(torch.int32))
    staged = stage(route, CPU, faces32, model, proj, H, W, light=light)
    assert_staged_like_prepare_draw(f"{route} i32 faces", staged, mesh,
                                    model, proj, light, (1.0,) * 4,
                                    "gouraud", H, W)


def test_on_the_cpu_the_stage_launches_nothing():
    launches = pvb.KERNEL_LAUNCHES
    mesh, model, proj, light = sphere_inputs(CPU)
    for route in ROUTES:
        stage(route, CPU, mesh, model, proj, H, W, light=light)
    assert pvb.KERNEL_LAUNCHES == launches


# --------------------------------------------------- against the reference


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_a_deferred_draw_matches_the_jax_reference(backend):
    """A textured Gouraud cube that reaches behind the camera, culling off
    (the near clip cuts faces in two), at 160x120 on the same backend of
    both packages (same inputs through convert.py): the reference's bar for
    f32 values against XLA:CPU's FMA-contracted programs
    (test_torch_pipeline._compare_to_reference)."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.models import primitives as jprim
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.shading import make_light as jmake_light
    from dtrenderer_tpu.utils import math3d as jm3
    from test_torch_pipeline import _compare_to_reference

    h, w = 120, 160
    mesh, tex = jprim.cube(), jprim.checkerboard(32, 4)
    model = jnp.asarray(jm3.model_matrix((0.3, 0.1, -2.0),
                                         jm3.rotate_y(0.5), 1.5))
    proj = jnp.asarray(jm3.perspective(1.2, w / h, 0.5, 20.0))
    light = jmake_light((0.4, 0.6, 1.0), 0.15)
    clear = [0.05, 0.05, 0.1, 1.0]
    kw = dict(shading="gouraud", sampling_mode="bilinear",
              color=(0.9, 0.8, 0.7, 1.0), cull_backfaces=False,
              backend=backend)
    ref = jax.jit(lambda fb: jpipe.draw_mesh(
        fb, mesh, model, proj, texture=tex, light=light, **kw))(
            jfb.clear(jfb.create(h, w), jnp.asarray(clear)))

    pmesh, ptex = convert.mesh(mesh, CPU), convert.texture(tex, CPU)
    pmodel, pproj = convert.matrix(model, CPU), convert.matrix(proj, CPU)
    plight = convert.light(light, CPU)
    out, c = ppipe.draw_mesh(pfb.clear(pfb.create(h, w, CPU), clear), pmesh,
                             pmodel, pproj, texture=ptex, light=plight,
                             return_counters=True, **kw)
    batch = ppipe.pack_draws([ppipe.DrawSpec(
        pmesh, pmodel, texture=ptex, color=kw["color"], shading="gouraud")],
        pproj, plight, "bilinear", w, h, cull_backfaces=False)
    assert int(batch.valid[1::2].sum()) > 0  # the near clip split some
    assert _compare_to_reference(ref.color, ref.depth, out.color, out.depth,
                                 batch) > 3000
    assert int(c.tris_submitted) == pmesh.faces.shape[0]


# --------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_on_the_card_one_vertex_launch_and_the_same_bits(route):
    from dtrenderer_tpu_torch.ops import vertex_graph

    def sightings():
        return (vertex_graph.EAGER, vertex_graph.CAPTURES,
                vertex_graph.REPLAYS)

    dev = _card()
    for shading in SHADINGS:
        for make in (sphere_inputs, near_inputs):
            mesh, model, proj, light = make(dev)
            graph = sightings()
            launches = pvb.KERNEL_LAUNCHES
            staged = stage(route, dev, mesh, model, proj, H, W, light=light,
                           color=COLOR, shading=shading)
            assert pvb.KERNEL_LAUNCHES == launches + 1
            assert sightings() == graph
            tag = f"card {route} {shading} {make.__name__}"
            assert_staged_like_prepare_draw(tag, staged, mesh, model, proj,
                                            light, COLOR, shading, H, W)
            c_mesh, c_model, c_proj, c_light = make(CPU)
            cpu = stage(route, CPU, c_mesh, c_model, c_proj, H, W,
                        light=c_light, color=COLOR, shading=shading)
            for name in ("coef", "bbox", "valid"):
                assert_bits(f"{tag} {name} card = CPU",
                            getattr(staged.setup, name),
                            getattr(cpu.setup, name))
            assert_bits(f"{tag} attrs10 card = CPU", staged.attrs10,
                        cpu.attrs10)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_on_the_card_edge_cases_stage_like_prepare_draw(route):
    dev = _card()
    cpu = list(edge_case_stagings(route, CPU))
    for (tag, staged, args), (_, want, _) in zip(
            edge_case_stagings(route, dev), cpu):
        assert_staged_like_prepare_draw(f"card {tag}", staged, *args)
        for name in ("coef", "bbox", "valid"):
            assert_bits(f"card {tag} {name} = CPU",
                        getattr(staged.setup, name),
                        getattr(want.setup, name))
        assert_bits(f"card {tag} attrs10 = CPU", staged.attrs10,
                    want.attrs10)

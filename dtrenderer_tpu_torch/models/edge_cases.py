"""Degenerate and non-finite draw inputs, shared by the CPU tests against the
JAX reference (`tests/test_torch_edge_cases.py`) and by chip_smoke.py's
card-against-CPU phase.

Each case is numpy data: the frame size, a view-projection matrix and a list
of opaque draws (mesh arrays, model matrix, texture, colour, shading,
sampling), with the draw call's culling and near-clip switches. Built from
seeds and from the package's own generators, so every consumer draws the
same bits:

  * the five cases of the reference's `tests/test_edge_cases.py` (a single
    triangle, NaN vertices beside a good triangle, a mesh off screen, a
    sub-pixel mesh far away, 4,000 triangles crammed into a few tiles);
  * textured triangles whose UV corners hold NaN, +inf, -inf, 1e12 and
    -1e12, sampled nearest and bilinear, with their texture at LUT base 0
    and at a base > 0 (two textures in one batch);
  * triangles with one vertex at +-1e12 pixels in x or in y, near clip off;
  * the reference's camera inside a box (`tests/test_clipping.py`), a
    triangle fan and a box with edges on integer pixel coordinates
    (`tests/test_fill_rule.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.utils import math3d as m3

CPU = torch.device("cpu")
BAD_VALUES = (float("nan"), float("inf"), -float("inf"), 1e12, -1e12)
LIGHT = ((0.4, 0.6, 1.0), 0.15)  # make_light(direction, ambient)


class Draw(NamedTuple):
    arrays: tuple               # make_mesh(verts, uv, normals, faces) args
    model: np.ndarray           # f32 [4, 4]
    texture: np.ndarray | None  # premultiplied f32 [th, tw, 4]
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    shading: str = "gouraud"
    sampling: str = "nearest"


class Case(NamedTuple):
    name: str
    height: int
    width: int
    view_proj: np.ndarray  # f32 [4, 4]
    draws: list
    cull_backfaces: bool = True
    near_clip: bool = True


def _mesh_arrays(mesh):
    return tuple(t.numpy() for t in mesh)


def _matrix(t) -> np.ndarray:
    return np.ascontiguousarray(t.numpy(), dtype=np.float32)


def _perspective(fov, aspect, near, far):
    return _matrix(m3.perspective(fov, aspect, near, far, device=CPU))


def _translate(x, y, z, scale=1.0):
    return _matrix(m3.model_matrix((x, y, z), scale_v=scale, device=CPU))


def screen_vertices(points, height, width, z_ndc=0.0):
    """Pixel positions (x, y) -> model-space vertices that an identity
    model and view-projection put exactly there (q = 1): x and y in NDC are
    dyadic for integer pixels, so the viewport transform is exact."""
    p = np.asarray(points, np.float64)
    x = p[:, 0] / (width / 2) - 1.0
    y = 1.0 - p[:, 1] / (height / 2)
    z = np.broadcast_to(np.asarray(z_ndc, np.float64), x.shape)
    return np.stack([x, y, z], -1).astype(np.float32)


def _flat_normals(n):
    return np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))


def _texture(seed, th, tw):
    """An opaque premultiplied texture of random texels."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.05, 1.0, (th, tw, 4)).astype(np.float32)
    tex[..., 3] = 1.0
    return tex


def single_triangle(h=32, w=128):
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0, 0.5, 0]],
                     np.float32)
    return Case("single triangle", h, w, _perspective(np.pi / 3, w / h, 0.1,
                                                      50.0),
                [Draw((verts, None, None, None), _translate(0, 0, -2),
                      None)])


def nan_vertices(h=32, w=128):
    verts = np.array(
        [[-0.5, -0.5, 0], [0.5, -0.5, 0], [0, 0.5, 0],
         [np.nan, 0.1, 0], [0.2, np.nan, 0], [0.3, 0.4, np.nan]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int64)
    return Case("NaN vertices", h, w, _perspective(np.pi / 3, w / h, 0.1,
                                                   50.0),
                [Draw((verts, None, _flat_normals(6), faces),
                      _translate(0, 0, -2), None)])


def offscreen_cube(h=32, w=128):
    return Case("cube off screen", h, w, _perspective(np.pi / 3, w / h, 0.1,
                                                      50.0),
                [Draw(_mesh_arrays(primitives.cube(device=CPU)),
                      _translate(100.0, 0, -5), None)])


def far_subpixel_cube(h=32, w=128):
    return Case("sub-pixel cube far away", h, w,
                _perspective(np.pi / 3, w / h, 0.1, 50.0),
                [Draw(_mesh_arrays(primitives.cube(device=CPU)),
                      _translate(0, 0, -45.0, 0.01), None)])


def crammed_soup(h=32, w=128):
    soup = primitives.random_triangle_soup(4000, rng_seed=5, extent=0.3,
                                           device=CPU)
    return Case("4000 triangles in a few tiles", h, w,
                _perspective(np.pi / 3, w / h, 0.1, 50.0),
                [Draw(_mesh_arrays(soup), _translate(0, 0, -1.0), None)],
                cull_backfaces=False, near_clip=False)


def nonfinite_uvs(h=32, w=128):
    """Four draws side by side, 32 pixels wide each: nearest and bilinear,
    each with a texture at LUT base 0 and one at a base > 0. A draw holds
    one thin triangle per value of BAD_VALUES, the value in u at its first
    corner and in v at its second."""
    textures = (_texture(1, 4, 8), _texture(2, 8, 4))
    draws = []
    for k, (sampling, tex) in enumerate(
            [("nearest", 0), ("nearest", 1), ("bilinear", 0),
             ("bilinear", 1)]):
        pts, uv = [], []
        for i, bad in enumerate(BAD_VALUES):
            x0 = 32 * k + 6.0 * i + 1.0
            pts += [(x0, 1.0), (x0 + 6.0, 2.0), (x0 + 3.0, h - 1.0)]
            uv += [(bad, 0.25), (0.75, bad), (0.5, 0.75)]
        n = len(pts)
        draws.append(Draw(
            (screen_vertices(pts, h, w), np.array(uv, np.float32),
             _flat_normals(n), np.arange(n).reshape(-1, 3)),
            np.eye(4, dtype=np.float32), textures[tex], sampling=sampling))
    return Case("non-finite and huge UVs", h, w, np.eye(4, dtype=np.float32),
                draws, cull_backfaces=False)


def huge_vertices(h=32, w=128):
    """Four valid triangles, each with one vertex at +-1e12 pixels in x or
    in y, at four depths."""
    tris = [[(10, 10), (40, 12), (1e12, 20)],
            [(100, 12), (120, 10), (-1e12, 20)],
            [(10, 10), (40, 12), (60, 1e12)],
            [(70, 30), (110, 28), (90, -1e12)]]
    verts = np.concatenate([
        screen_vertices(t, h, w, z_ndc=-0.3 + 0.2 * i)
        for i, t in enumerate(tris)])
    return Case("one vertex at +-1e12 px", h, w, np.eye(4, dtype=np.float32),
                [Draw((verts, None, _flat_normals(12), None),
                      np.eye(4, dtype=np.float32), None)],
                cull_backfaces=False, near_clip=False)


def camera_in_box(h=64, w=128):
    box = primitives.cube(device=CPU)
    return Case("camera inside a box", h, w,
                _perspective(np.pi / 2, 2.0, 0.05, 50.0),
                [Draw(_mesh_arrays(box), _matrix(m3.scale(3.0, device=CPU)),
                      None, color=(0.8, 0.4, 0.3, 1.0))],
                cull_backfaces=False)


def triangle_fan(h=32, w=128, n=12):
    cx, cy = 64.0, 16.0
    angs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = [(cx + 40 * np.cos(a), cy + 14 * np.sin(a)) for a in angs]
    pts = np.array([(cx, cy)] + ring)
    faces = np.array([(0, 1 + i, 1 + (i + 1) % n) for i in range(n)])
    return Case("triangle fan", h, w, np.eye(4, dtype=np.float32),
                [Draw((screen_vertices(pts, h, w), None,
                       _flat_normals(n + 1), faces),
                      np.eye(4, dtype=np.float32), None)],
                cull_backfaces=False)


def integer_edges(h=32, w=128):
    pts = [(8.0, 8.0), (24.0, 8.0), (24.0, 16.0), (8.0, 16.0)]
    faces = np.array([(0, 1, 2), (0, 2, 3)])
    return Case("box on integer edges", h, w, np.eye(4, dtype=np.float32),
                [Draw((screen_vertices(pts, h, w), None, _flat_normals(4),
                       faces), np.eye(4, dtype=np.float32), None)],
                cull_backfaces=False)


CASES = {f.__name__: f for f in (
    single_triangle, nan_vertices, offscreen_cube, far_subpixel_cube,
    crammed_soup, nonfinite_uvs, huge_vertices, camera_in_box, triangle_fan,
    integer_edges)}


# ----------------------------------------------------------- on the port

# draw_mesh backends, then the ordered engines of draw_mesh_ordered
ROUTES = ("fused", "pallas", "ref", "tile", "scan")
CLEAR = (0.0, 0.0, 0.0, 1.0)


def draw_specs(case: Case, device):
    """The case's draws as pipeline.DrawSpecs on `device`; a texture that
    several draws share is one tensor, so the LUT stores it once."""
    from dtrenderer_tpu_torch.models.mesh import make_mesh
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec

    textures = {}
    specs = []
    for d in case.draws:
        tex = None
        if d.texture is not None:
            tex = textures.setdefault(
                id(d.texture), torch.from_numpy(d.texture).to(device))
        specs.append(DrawSpec(make_mesh(*d.arrays, device=device),
                              torch.from_numpy(d.model).to(device),
                              texture=tex, color=d.color, shading=d.shading,
                              sampling=d.sampling))
    return specs


def render(case: Case, route: str, device, light=None):
    """The case drawn on one route into a cleared framebuffer: "fused" is
    one draw_meshes (one K1 launch for all draws), "pallas" and "ref" one
    draw_mesh per draw, "tile" and "scan" one draw_mesh_ordered per draw."""
    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops import pipeline
    from dtrenderer_tpu_torch.ops.shading import make_light

    if light is None:
        light = make_light(*LIGHT, device=device)
    specs = draw_specs(case, device)
    view_proj = torch.from_numpy(case.view_proj).to(device)
    fb = fblib.clear(fblib.create(case.height, case.width, device), CLEAR)
    kw = dict(light=light, cull_backfaces=case.cull_backfaces,
              near_clip=case.near_clip)
    if route == "fused":
        return pipeline.draw_meshes(fb, view_proj, specs, **kw)
    for s in specs:
        kw.update(texture=s.texture, color=s.color, shading=s.shading,
                  sampling_mode=s.sampling)
        if route in ("tile", "scan"):
            fb = pipeline.draw_mesh_ordered(fb, s.mesh, s.model, view_proj,
                                            engine=route, **kw)
        else:
            fb = pipeline.draw_mesh(fb, s.mesh, s.model, view_proj,
                                    backend=route, **kw)
    return fb


def pack(case: Case, device, light=None):
    """(DrawBatch of all the case's draws, Bins of the whole frame, light):
    the three kernels' inputs, a texture at LUT base > 0 included."""
    from dtrenderer_tpu_torch.ops import binning, pipeline
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.ops.shading import make_light

    if light is None:
        light = make_light(*LIGHT, device=device)
    batch = pipeline.pack_draws(
        draw_specs(case, device), torch.from_numpy(case.view_proj).to(device),
        light, "nearest", case.width, case.height, case.cull_backfaces,
        case.near_clip)
    bins = binning.bin_triangles(batch.coef, batch.bbox, batch.valid,
                                 case.height, case.width, 0, 0, rf.TILE_H,
                                 rf.TILE_W)
    return batch, bins, light

"""The five BASELINE scenes as frame functions.

Port of `dtrenderer_tpu/models/scenes.py`:
  1. single flat-shaded triangle, 800x600
  2. textured spinning cube, z-buffered, nearest, 800x600
  3. ~5k-tri OBJ (data/head.obj), Gouraud + bilinear, 800x600
  4. multi-mesh, perspective-correct UVs + per-pixel Phong, bilinear, 1080p
     (head.obj + cube + two spheres)
  5. 1M-triangle stress soup at 4K: gouraud, nearest, the 64^2 gradient
     texture, near_clip=False (the soup never crosses the near plane)

make_configN(..., backend, device) puts the scene's meshes and textures on
`device`; its frame(color, depth, t, y_offset=0, frame_height=None,
frame_width=None, x_offset=0) renders there through `backend` ("fused",
"pallas" or "ref", as pipeline.draw_mesh) and returns (color, depth), and
its submission(t) returns what that frame submits (for tools that drive the
pipeline's stages one by one). The band arguments are the reference's: when
(color, depth) is a band or tile of the frame (parallel/shard.py), they give
the whole frame's size and the tile's origin in it. Config 4 is one batched
draw_meshes call on "fused" and four sequential draw_mesh calls otherwise,
as in the reference. No scene passes raster_opts.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.ops import fb as fblib
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.pipeline import DrawSpec, draw_mesh, draw_meshes
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as m3

F32 = torch.float32

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


class Submission(NamedTuple):
    """What one frame submits to the pipeline."""
    view_proj: torch.Tensor
    draws: list            # [pipeline.DrawSpec]
    light: object          # shading.Light
    sampling_mode: str
    near_clip: bool


class SceneSpec(NamedTuple):
    name: str
    width: int
    height: int
    n_tris: int
    frame: Callable       # frame(color, depth, t, <band args>) -> (color, depth)
    submission: Callable  # submission(t) -> Submission


def _clear(color, depth, rgba):
    return fblib.clear(Framebuffer(color, depth), rgba)


def head_mesh(device):
    from dtrenderer_tpu_torch.assets.obj import load_obj

    return load_obj(os.path.join(DATA_DIR, "head.obj"), device=device)


def head_texture(device):
    from dtrenderer_tpu_torch.assets.image import load_bitmap

    path = os.path.join(DATA_DIR, "texture.png")
    if os.path.exists(path):
        return load_bitmap(path, device=device)
    return primitives.gradient_texture(128, device=device)


def _one_draw_frame(submission, clear_rgba, backend):
    """frame() of a one-draw scene: clear, then draw_mesh on `backend`."""

    def frame(color, depth, t, y_offset=0, frame_height=None,
              frame_width=None, x_offset=0):
        sub = submission(t)
        d = sub.draws[0]
        fb = _clear(color, depth, clear_rgba)
        fb = draw_mesh(fb, d.mesh, d.model, sub.view_proj, texture=d.texture,
                       light=sub.light, color=d.color, shading=d.shading,
                       sampling_mode=sub.sampling_mode, backend=backend,
                       y_offset=y_offset, x_offset=x_offset,
                       frame_height=frame_height, frame_width=frame_width,
                       near_clip=sub.near_clip)
        return fb.color, fb.depth

    return frame


def make_config1(width=800, height=600, backend="fused", *,
                 device) -> SceneSpec:
    """Single flat-shaded triangle into an 800x600 RGBA framebuffer."""
    from dtrenderer_tpu_torch.models.mesh import make_mesh

    verts = np.array(
        [[-0.7, -0.6, 0.0], [0.7, -0.5, 0.0], [0.0, 0.7, 0.0]], np.float32
    )
    mesh = make_mesh(verts, None, np.tile([[0.0, 0.0, 1.0]], (3, 1)),
                     np.array([[0, 1, 2]], np.int32), device=device)
    proj = m3.perspective(np.pi / 3, width / height, 0.1, 50.0, device=device)
    light = make_light((0.0, 0.0, 1.0), 0.2, device=device)

    def submission(t) -> Submission:
        t = torch.as_tensor(t, dtype=F32)
        mdl = m3.model_matrix((0.0, 0.0, -2.0),
                              m3.rotate_z(t * 0.5, device=device),
                              device=device)
        return Submission(proj, [DrawSpec(mesh, mdl,
                                          color=(0.9, 0.35, 0.2, 1.0),
                                          shading="flat")],
                          light, "nearest", True)

    return SceneSpec("config1_flat_triangle", width, height, 1,
                     _one_draw_frame(submission, [0.05, 0.05, 0.08, 1.0],
                                     backend), submission)


def make_config2(width=800, height=600, backend="fused", *,
                 device) -> SceneSpec:
    """Textured spinning cube, z-buffered, nearest-neighbor sampling."""
    mesh = primitives.cube(device=device)
    tex = primitives.checkerboard(64, 8, (1.0, 0.85, 0.3, 1.0),
                                  (0.15, 0.15, 0.5, 1.0), device=device)
    proj = m3.perspective(np.pi / 3, width / height, 0.1, 50.0, device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)

    def submission(t) -> Submission:
        t = torch.as_tensor(t, dtype=F32)
        mdl = m3.model_matrix((0, 0, -4.5),
                              m3.mat4mul(m3.rotate_y(t, device=device),
                                         m3.rotate_x(t * 0.6, device=device)),
                              device=device)
        return Submission(proj, [DrawSpec(mesh, mdl, texture=tex,
                                          shading="flat")],
                          light, "nearest", True)

    return SceneSpec("config2_textured_cube", width, height, mesh.num_tris,
                     _one_draw_frame(submission, [0.05, 0.05, 0.08, 1.0],
                                     backend), submission)


def make_config3(width=800, height=600, backend="fused", *,
                 device) -> SceneSpec:
    """~5k-tri OBJ mesh with Gouraud shading + bilinear textures."""
    mesh = head_mesh(device)
    tex = head_texture(device)
    proj = m3.perspective(np.pi / 3, width / height, 0.1, 50.0, device=device)
    light = make_light((0.5, 0.4, 1.0), 0.12, device=device)

    def submission(t) -> Submission:
        t = torch.as_tensor(t, dtype=F32)
        mdl = m3.model_matrix((0, 0, -2.6), m3.rotate_y(t, device=device),
                              1.2, device=device)
        return Submission(proj, [DrawSpec(mesh, mdl, texture=tex,
                                          shading="gouraud")],
                          light, "bilinear", True)

    return SceneSpec("config3_obj_gouraud", width, height, mesh.num_tris,
                     _one_draw_frame(submission, [0.04, 0.05, 0.09, 1.0],
                                     backend), submission)


def make_config4(width=1920, height=1080, backend="fused", *,
                 device) -> SceneSpec:
    """Multi-mesh scene, perspective-correct UVs + per-pixel Phong at 1080p."""
    head = head_mesh(device)
    cube = primitives.cube(device=device)
    sphere = primitives.uv_sphere(24, 32, device=device)
    tex = head_texture(device)
    checker = primitives.checkerboard(64, 8, device=device)
    proj = m3.perspective(np.pi / 3, width / height, 0.1, 100.0, device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    n_tris = head.num_tris + cube.num_tris + sphere.num_tris * 2

    def submission(t) -> Submission:
        t = torch.as_tensor(t, dtype=F32)
        mm = m3.model_matrix

        def rot_y(a):
            return m3.rotate_y(a, device=device)

        draws = [
            DrawSpec(head, mm((-1.3, 0.1, -3.0), rot_y(t), 1.3, device=device),
                     texture=tex, shading="phong"),
            DrawSpec(cube, mm((1.5, -0.3, -4.6),
                              m3.mat4mul(rot_y(t * 0.8),
                                         m3.rotate_x(0.4, device=device)),
                              device=device),
                     texture=checker, shading="phong"),
            DrawSpec(sphere, mm((0.6, 1.0, -5.5), rot_y(t * 0.5), 1.1,
                                device=device),
                     color=(0.8, 0.5, 0.9, 1.0), shading="phong"),
            DrawSpec(sphere, mm((-0.4, -1.0, -6.0), rot_y(-t), 1.4,
                                device=device),
                     color=(0.4, 0.9, 0.6, 1.0), shading="phong"),
        ]
        return Submission(proj, draws, light, "bilinear", True)

    def frame(color, depth, t, y_offset=0, frame_height=None,
              frame_width=None, x_offset=0):
        sub = submission(t)
        fb = _clear(color, depth, [0.03, 0.03, 0.06, 1.0])
        band = dict(y_offset=y_offset, x_offset=x_offset,
                    frame_height=frame_height, frame_width=frame_width)
        if backend == "fused":
            # one batched fused submission (bit-identical to sequential draws)
            fb = draw_meshes(fb, sub.view_proj, sub.draws, light=sub.light,
                             sampling_mode=sub.sampling_mode, **band)
        else:
            for d in sub.draws:
                fb = draw_mesh(fb, d.mesh, d.model, sub.view_proj,
                               texture=d.texture, light=sub.light,
                               color=d.color, shading=d.shading,
                               sampling_mode=sub.sampling_mode,
                               backend=backend, **band)
        return fb.color, fb.depth

    return SceneSpec("config4_multimesh_phong", width, height, n_tris, frame,
                     submission)


def make_config5(width=3840, height=2160, n_tris=1_000_000, backend="fused",
                 *, device) -> SceneSpec:
    """1M-triangle stress soup at 4K."""
    soup = primitives.random_triangle_soup(n_tris, rng_seed=11, extent=1.6,
                                           device=device)
    tex = primitives.gradient_texture(64, device=device)
    proj = m3.perspective(np.pi / 3, width / height, 0.1, 50.0, device=device)
    light = make_light((0.3, 0.5, 1.0), 0.2, device=device)

    def submission(t) -> Submission:
        t = torch.as_tensor(t, dtype=F32)
        mdl = m3.model_matrix((0, 0, -2.8),
                              m3.rotate_y(t * 0.3, device=device),
                              device=device)
        draws = [DrawSpec(soup, mdl, texture=tex, shading="gouraud")]
        # the soup never crosses the near plane
        return Submission(proj, draws, light, "nearest", False)

    return SceneSpec("config5_1m_tri_4k", width, height, n_tris,
                     _one_draw_frame(submission, [0.02, 0.02, 0.04, 1.0],
                                     backend), submission)


ALL_CONFIGS = {
    1: make_config1,
    2: make_config2,
    3: make_config3,
    4: make_config4,
    5: make_config5,
}

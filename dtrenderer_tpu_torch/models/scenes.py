"""BASELINE scenes 4 and 5 as frame functions.

Port of `make_config4` and `make_config5` from
`dtrenderer_tpu/models/scenes.py`:
  4. multi-mesh, perspective-correct UVs + per-pixel Phong, bilinear, 1080p
     (head.obj + cube + two spheres, one batched draw_meshes call)
  5. 1M-triangle stress soup at 4K: gouraud, nearest, the 64^2 gradient
     texture, near_clip=False (the soup never crosses the near plane)

make_configN(..., device) puts the scene's meshes and textures on `device`;
its frame(color, depth, t) renders there and returns (color, depth), and its
submission(t) returns what that frame submits (for tools that drive the
pipeline's stages one by one).
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
    frame: Callable       # frame(color, depth, t) -> (color, depth)
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


def make_config4(width=1920, height=1080, *, device) -> SceneSpec:
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

    def frame(color, depth, t):
        sub = submission(t)
        fb = _clear(color, depth, [0.03, 0.03, 0.06, 1.0])
        fb = draw_meshes(fb, sub.view_proj, sub.draws, light=sub.light,
                         sampling_mode=sub.sampling_mode)
        return fb.color, fb.depth

    return SceneSpec("config4_multimesh_phong", width, height, n_tris, frame,
                     submission)


def make_config5(width=3840, height=2160, n_tris=1_000_000, *,
                 device) -> SceneSpec:
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

    def frame(color, depth, t):
        sub = submission(t)
        d = sub.draws[0]
        fb = _clear(color, depth, [0.02, 0.02, 0.04, 1.0])
        fb = draw_mesh(fb, d.mesh, d.model, sub.view_proj, texture=d.texture,
                       light=sub.light, shading=d.shading,
                       sampling_mode=sub.sampling_mode, backend="fused",
                       near_clip=sub.near_clip)
        return fb.color, fb.depth

    return SceneSpec("config5_1m_tri_4k", width, height, n_tris, frame,
                     submission)

"""Screen-space stress geometry for the raster kernels' checks.

Shapes the package's scenes do not reach: a tile whose bin is deeper than
two staging chunks of the kernels, and a triangle grid whose shared edges
run exactly through pixel centres and along the kernels' sub-block borders
(every E == 0 top-left decision, per pixel and per sub-block corner). The
CPU tests, the `gpu` tests and chip_smoke.py share them (`CASES`, `windows`,
`mesh_of_corners` for the vertex stage).
Each generator returns numpy corners f32 [T, 3, 4] of (sx, sy, sz, q), made
from a seed; `setup` and `payload` turn them into the kernels' inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from dtrenderer_tpu_torch.ops import geometry, render_fused


def deep_tile(n_tris=700, seed=0, centre=(40.0, 24.0)):
    """n_tris triangles piled on one spot: most within one 16x16 tile, every
    eighth several tiles wide, depths quantised so that exact ties occur."""
    rng = np.random.default_rng(seed)
    size = np.where(np.arange(n_tris) % 8 == 0, 30.0, 7.0)[:, None, None]
    c = np.zeros((n_tris, 3, 4), np.float32)
    c[..., :2] = (np.asarray(centre) + rng.uniform(-4, 4, (n_tris, 1, 2))
                  + rng.uniform(-1, 1, (n_tris, 3, 2)) * size)
    c[..., 2] = np.round(rng.uniform(0.05, 0.95, (n_tris, 3)) * 16) / 16
    c[..., 3] = 1.0
    return c


def shared_edge_grid(height, width, step=4, origin=0.5, seed=0):
    """A grid of squares of `step` pixels from `origin` (0.5: edges through
    pixel centres; 0.0: edges along sub-block borders, diagonals through
    pixel centres), each cut into two triangles of either winding, over and
    a little beyond a height x width frame. Depth varies per vertex."""
    rng = np.random.default_rng(seed)
    xs = origin + step * np.arange(-1, width // step + 2)
    ys = origin + step * np.arange(-1, height // step + 2)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    gz = rng.uniform(0.1, 0.9, gx.shape)
    v = np.stack([gx, gy, gz, np.ones_like(gx)], -1).astype(np.float32)
    a, b, c, d = v[:-1, :-1], v[:-1, 1:], v[1:, 1:], v[1:, :-1]
    tris = np.concatenate([np.stack([a, b, c], 2).reshape(-1, 3, 4),
                           np.stack([a, d, c], 2).reshape(-1, 3, 4)])
    return tris[rng.permutation(len(tris))]


# The checks' cases: name -> (corners, frame height, frame width).
CASES = {
    "deep_tile": lambda: (deep_tile(), 48, 80),
    "grid_centres": lambda: (shared_edge_grid(64, 96, origin=0.5), 64, 96),
    "grid_borders": lambda: (shared_edge_grid(64, 96, origin=0.0), 64, 96),
}


def windows(height, width):
    """The windows each case is rendered in, (y_offset, x_offset, height,
    width): the whole frame and two shards whose size is no multiple of the
    tile or the sub-block, at non-zero offsets."""
    return ((0, 0, height, width), (13, 21, 29, 43), (3, 5, 41, 70))


def setup(corners, height, width, device):
    """Corners [T, 3, 4] -> geometry.TriSetup on `device` (no culling)."""
    t = torch.tensor(np.asarray(corners, np.float32), device=device)
    return geometry.triangle_setup_from_corners(t[:, 0], t[:, 1], t[:, 2],
                                                width, height,
                                                cull_backfaces=False)


def mesh_of_corners(corners, height, width, device):
    """A mesh that an identity model and view-projection put at the screen
    corners [T, 3, 4] (unwelded, three vertices a triangle): the vertex
    stage's input for these shapes."""
    from dtrenderer_tpu_torch.models import edge_cases
    from dtrenderer_tpu_torch.models.mesh import make_mesh

    c = np.asarray(corners, np.float32)
    verts = edge_cases.screen_vertices(
        c[..., :2].reshape(-1, 2), height, width,
        z_ndc=2.0 * c[..., 2].reshape(-1) - 1.0)
    return make_mesh(verts, None, None, np.arange(len(verts)).reshape(-1, 3),
                     device=device)


def payload(corners, seed, device):
    """A payload [T, 34] for `corners` (random uv, rgba and normals,
    nearest sampling, Phong on every other triangle) and a 1x1 white
    texture LUT: what K1 shades in the stress checks."""
    rng = np.random.default_rng(seed)
    T = len(corners)
    q = np.asarray(corners, np.float32)[..., 3:4]
    raw = rng.uniform(0.1, 1.0, (T, 3, 9)).astype(np.float32)
    attrs = torch.tensor(np.concatenate([q, raw * q], -1), device=device)
    lut, meta = render_fused.make_texture_lut(
        [torch.ones((1, 1, 4), device=device)])
    rows = render_fused.pack_payload(attrs, meta[0],
                                     render_fused.pack_flags(False, False))
    rows[1::2, render_fused.P_FLAGS] = render_fused.pack_flags(True, False)
    return rows, lut

"""Procedural meshes and textures for demos, tests and benchmarks.

Port of `dtrenderer_tpu/models/primitives.py`: the numpy generators are kept
as they are, so both packages build bit-identical geometry and texels; only
the final arrays land on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from dtrenderer_tpu_torch.models.mesh import Mesh, make_mesh


def cube(*, device) -> Mesh:
    """Unit cube [-1,1]^3, 24 welded verts (per-face normals/uv), 12 tris, CCW."""
    faces_def = [
        # (normal, corner order, +u axis, +v axis) — CCW seen from outside
        ((0, 0, 1), (-1, -1, 1), (1, 0, 0), (0, 1, 0)),   # front  (+z)
        ((0, 0, -1), (1, -1, -1), (-1, 0, 0), (0, 1, 0)),  # back   (-z)
        ((1, 0, 0), (1, -1, 1), (0, 0, -1), (0, 1, 0)),    # right  (+x)
        ((-1, 0, 0), (-1, -1, -1), (0, 0, 1), (0, 1, 0)),  # left   (-x)
        ((0, 1, 0), (-1, 1, 1), (1, 0, 0), (0, 0, -1)),    # top    (+y)
        ((0, -1, 0), (-1, -1, -1), (1, 0, 0), (0, 0, 1)),  # bottom (-y)
    ]
    verts, uvs, normals, faces = [], [], [], []
    for n, origin, du, dv in faces_def:
        o = np.array(origin, np.float32)
        du = np.array(du, np.float32) * 2
        dv = np.array(dv, np.float32) * 2
        base = len(verts)
        for (su, sv) in [(0, 0), (1, 0), (1, 1), (0, 1)]:
            verts.append(o + du * su + dv * sv)
            uvs.append((su, sv))
            normals.append(n)
        faces.append((base + 0, base + 1, base + 2))
        faces.append((base + 0, base + 2, base + 3))
    return make_mesh(
        np.array(verts, np.float32),
        np.array(uvs, np.float32),
        np.array(normals, np.float32),
        np.array(faces, np.int32),
        device=device,
    )


def plane(size=1.0, *, device) -> Mesh:
    """The square [-size, size]^2 in the y = 0 plane, normal +y, 2 tris."""
    s = float(size)
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return make_mesh(verts, uv, normals, faces, device=device)


def uv_sphere(n_lat=16, n_lon=24, radius=1.0, *, device) -> Mesh:
    """UV sphere with welded grid verts; poles handled as degenerate-free rows."""
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon + 1)
    lat, lon = np.meshgrid(lats, lons, indexing="ij")
    x = np.sin(lat) * np.cos(lon)
    y = np.cos(lat)
    z = np.sin(lat) * np.sin(lon)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32) * radius
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    u = lon / (2 * np.pi)
    v = 1.0 - lat / np.pi
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    faces = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((b, d, c))
    return make_mesh(verts, uv, normals, np.array(faces, np.int32),
                     device=device)


def checkerboard(size=64, cells=8, c0=(1.0, 1.0, 1.0, 1.0),
                 c1=(0.2, 0.2, 0.2, 1.0), *, device):
    """Premultiplied linear f32 checker texture [size, size, 4]."""
    ij = np.arange(size) * cells // size
    mask = (ij[:, None] + ij[None, :]) % 2
    tex = np.where(
        mask[..., None].astype(bool),
        np.array(c1, np.float32),
        np.array(c0, np.float32),
    ).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(tex)).to(device)


def gradient_texture(size=64, *, device):
    """Premultiplied linear f32 RGBA gradient texture [size, size, 4]."""
    u = np.linspace(0, 1, size, dtype=np.float32)
    r, g = np.meshgrid(u, u, indexing="xy")
    tex = np.stack([r, g, 1.0 - r * g, np.ones_like(r)], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(tex)).to(device)


def white_texture(*, device):
    return torch.ones((1, 1, 4), dtype=torch.float32, device=device)


def random_triangle_soup(n_tris, rng_seed=0, extent=1.0, *, device) -> Mesh:
    """n_tris random small triangles in a cube — the config-5 stress scene body."""
    rng = np.random.default_rng(rng_seed)
    centers = rng.uniform(-extent, extent, (n_tris, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-0.02 * extent, 0.02 * extent, (n_tris, 3, 3)).astype(
        np.float32
    )
    verts = (centers + offsets).reshape(-1, 3)
    uv = rng.uniform(0, 1, (n_tris * 3, 2)).astype(np.float32)
    return make_mesh(verts, uv, None, None, device=device)

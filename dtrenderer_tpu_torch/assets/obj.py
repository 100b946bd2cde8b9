"""Wavefront OBJ loading.

Port of `dtrenderer_tpu/assets/obj.py`. Files are parsed by the native C++
parser through the port's `assets/native.py` (ctypes + numpy). Text input
goes through the pure-Python parser below, a copy of the reference's. The
result is welded into a unified vertex buffer (models/mesh.py).
"""

from __future__ import annotations

import io

import numpy as np

from dtrenderer_tpu_torch.assets import native
from dtrenderer_tpu_torch.models.mesh import (
    Mesh, compute_vertex_normals, make_mesh, weld,
)


def parse_obj_text(text: str):
    """Parse OBJ source -> (positions [Nv,3], uvs [Nt,2], normals [Nn,3],
    pos_idx [T,3], uv_idx [T,3] or None, n_idx [T,3] or None) as numpy arrays.
    Indices are 0-based; -1 marks 'corner has no vt/vn'."""
    positions: list[tuple] = []
    uvs: list[tuple] = []
    normals: list[tuple] = []
    pos_idx: list[tuple] = []
    uv_idx: list[tuple] = []
    n_idx: list[tuple] = []
    any_uv = False
    any_n = False

    def resolve(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i

    for raw in io.StringIO(text):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vt":
            u = float(parts[1])
            v = float(parts[2]) if len(parts) > 2 else 0.0
            uvs.append((u, v))
        elif tag == "vn":
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "f":
            corners = []
            for spec in parts[1:]:
                fields = spec.split("/")
                vi = resolve(int(fields[0]), len(positions))
                ti = ni = -1
                if len(fields) > 1 and fields[1]:
                    ti = resolve(int(fields[1]), len(uvs))
                    any_uv = True
                if len(fields) > 2 and fields[2]:
                    ni = resolve(int(fields[2]), len(normals))
                    any_n = True
                corners.append((vi, ti, ni))
            for k in range(1, len(corners) - 1):  # fan triangulation
                tri = (corners[0], corners[k], corners[k + 1])
                pos_idx.append(tuple(c[0] for c in tri))
                uv_idx.append(tuple(c[1] for c in tri))
                n_idx.append(tuple(c[2] for c in tri))
        # o/g/s/usemtl/mtllib ignored (the reference's parser reads geometry only)

    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(uvs, np.float32).reshape(-1, 2) if any_uv else None,
        np.asarray(normals, np.float32).reshape(-1, 3) if any_n else None,
        np.asarray(pos_idx, np.int64).reshape(-1, 3),
        np.asarray(uv_idx, np.int64).reshape(-1, 3) if any_uv else None,
        np.asarray(n_idx, np.int64).reshape(-1, 3) if any_n else None,
    )


def mesh_from_parsed(positions, uvs, normals, pos_idx, uv_idx, n_idx, *,
                     device) -> Mesh:
    verts, uv, welded_normals, faces = weld(
        positions, pos_idx, uvs, uv_idx, normals, n_idx
    )
    if welded_normals is None:
        welded_normals = compute_vertex_normals(verts, faces)
    return make_mesh(verts, uv, welded_normals, faces, device=device)


def load_obj_text(text: str, *, device) -> Mesh:
    return mesh_from_parsed(*parse_obj_text(text), device=device)


def load_obj(path: str, *, device) -> Mesh:
    """Load an OBJ file with the native parser. Raises ImportError when
    `native/libdtr_native.so` cannot be loaded."""
    return mesh_from_parsed(*native.parse_obj_file(path), device=device)

"""Mesh representation: welded, array-first.

Port of `dtrenderer_tpu/models/mesh.py`. `compute_vertex_normals` and `weld`
are host-side numpy, copied unchanged: `head.obj` has no normals, so the
`np.add.at` accumulation order decides the normals' bits, and both packages
must share it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32


class Mesh(NamedTuple):
    verts: torch.Tensor    # f32 [N, 3] model-space positions
    uv: torch.Tensor       # f32 [N, 2] texcoords (v up, Wavefront convention)
    normals: torch.Tensor  # f32 [N, 3] vertex normals (unnormalized ok)
    faces: torch.Tensor    # i64 [T, 3] indices into the welded vertex buffer

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]


def make_mesh(verts, uv=None, normals=None, faces=None, *, device) -> Mesh:
    """Build a Mesh on `device` from numpy arrays (or array-likes)."""
    verts = np.asarray(verts, np.float32)
    n = verts.shape[0]
    if faces is None:
        faces = np.arange(n, dtype=np.int64).reshape(-1, 3)
    faces = np.asarray(faces, np.int64)
    uv = np.zeros((n, 2), np.float32) if uv is None else np.asarray(
        uv, np.float32)
    if normals is None:
        normals = compute_vertex_normals(verts, faces)
    normals = np.asarray(normals, np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Mesh(verts=dev(verts), uv=dev(uv), normals=dev(normals),
                faces=dev(faces))


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side; used when the asset has none)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    out = np.zeros_like(verts)
    for c in range(3):
        np.add.at(out, faces[:, c], fn)
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    norms[norms == 0] = 1.0
    return (out / norms).astype(np.float32)


def weld(positions, pos_idx, uvs=None, uv_idx=None, normals=None, n_idx=None):
    """Weld OBJ-style multi-index faces into a unified vertex buffer.

    positions: [Nv,3] f32; pos_idx/uv_idx/n_idx: [T,3] int per-corner indices
    (uv/n may be None). Returns (verts, uv, normals_or_None, faces) numpy arrays.
    """
    pos_idx = np.asarray(pos_idx, np.int64)
    t = pos_idx.shape[0]
    uvi = np.asarray(uv_idx, np.int64) if uv_idx is not None else np.full((t, 3), -1)
    nni = np.asarray(n_idx, np.int64) if n_idx is not None else np.full((t, 3), -1)
    key = np.stack([pos_idx, uvi, nni], axis=-1).reshape(-1, 3)  # [T*3, 3]
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(t, 3).astype(np.int32)
    verts = np.asarray(positions, np.float32)[uniq[:, 0]]
    # -1 is the "corner has no vt/vn" sentinel (mixed OBJ faces): mask those rows
    # to zero instead of letting -1 silently index the LAST uv/normal.
    if uvs is not None and uv_idx is not None:
        ui = uniq[:, 1]
        uv = np.asarray(uvs, np.float32)[np.maximum(ui, 0)]
        uv[ui < 0] = 0.0
    else:
        uv = np.zeros((uniq.shape[0], 2), np.float32)
    if normals is not None and n_idx is not None:
        ni = uniq[:, 2]
        normals = np.asarray(normals, np.float32)[np.maximum(ni, 0)]
        normals[ni < 0] = 0.0  # zero normal -> ambient-lit (FORMULAS.md guard)
    else:
        normals = None
    return verts, uv, normals, faces

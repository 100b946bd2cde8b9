"""Carry the JAX package's state over to the port, bit for bit.

Every function takes array-likes (numpy arrays, or the reference's arrays,
which numpy reads without this module importing JAX) and returns the port's
tensors on `device` with the same bits. The tests use it so both packages
render identical scene data — matrices included, since `jnp.cos` and
`torch.cos` may differ in the last ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from dtrenderer_tpu_torch.models.mesh import Mesh
from dtrenderer_tpu_torch.ops.shading import Light


def tensor(a, device, dtype=np.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=dtype), device=device)


def mesh(m, device) -> Mesh:
    """A Mesh(verts, uv, normals, faces) of arrays -> the port's Mesh."""
    return Mesh(
        verts=tensor(m.verts, device),
        uv=tensor(m.uv, device),
        normals=tensor(m.normals, device),
        faces=tensor(m.faces, device, np.int64),
    )


def texture(t, device) -> torch.Tensor:
    """[h, w, 4] premultiplied linear f32 texture."""
    return tensor(t, device)


def matrix(m, device) -> torch.Tensor:
    """4x4 f32 matrix."""
    return tensor(m, device)


def light(l, device) -> Light:
    """Light(direction [3], ambient []) -> the port's Light."""
    return Light(direction=tensor(l.direction, device),
                 ambient=tensor(l.ambient, device))

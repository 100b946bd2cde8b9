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

from dtrenderer_tpu_torch.api import RenderState
from dtrenderer_tpu_torch.assets.font import Font
from dtrenderer_tpu_torch.models.mesh import Mesh
from dtrenderer_tpu_torch.ops.draw2d import Transform2D
from dtrenderer_tpu_torch.ops.fb import Framebuffer
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


def font(f, device) -> Font:
    """Font(atlas, cell_w, cell_h, advances) -> the port's Font."""
    return Font(atlas=tensor(f.atlas, device), cell_w=int(f.cell_w),
                cell_h=int(f.cell_h),
                advances=(None if f.advances is None
                          else tensor(f.advances, device)))


def framebuffer(fb, device) -> Framebuffer:
    """Framebuffer(color [H, W, 4], depth [H, W]) -> the port's."""
    return Framebuffer(color=tensor(fb.color, device),
                       depth=tensor(fb.depth, device))


def render_state(s, device) -> RenderState:
    """RenderState(fb) -> the port's."""
    return RenderState(fb=framebuffer(s.fb, device))


def transform2d(t, device) -> Transform2D:
    """Transform2D(rotation [], scale [2], anchor [2]) -> the port's."""
    return Transform2D(rotation=tensor(t.rotation, device),
                       scale=tensor(t.scale, device),
                       anchor=tensor(t.anchor, device))

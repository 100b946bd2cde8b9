"""3D math: 4x4 matrices, projection, point/direction transforms.

Port of `dtrenderer_tpu/utils/math3d.py`. Matrices act on column vectors
(v' = M @ v); batched points of shape [N, 4] transform with `transform_points`.

Matrix composition contract (FORMULAS.md): every product is written out as
explicit broadcasts in a fixed op order. `torch.matmul` / `@` is never used
here: on the card a float32 matmul may run in TF32, and any matmul sums in an
order of its own, so the bits would differ from the JAX reference.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32
I32_MAX = 2**31 - 1
F32_BELOW_2_31 = 2147483520.0  # the largest float32 below 2^31


def to_i32(x):
    """float32 -> int32 as XLA converts: truncate toward zero, NaN -> 0,
    x >= 2^31 -> INT_MAX, x < -2^31 -> INT_MIN.

    A bare `.to(torch.int32)` of a value outside the int32 range, or of NaN,
    is undefined in C++: ATen on the CPU gives INT_MIN for all of them, so
    every float-to-int32 conversion of the port goes through here. The
    values are brought into range in float first; torch's cast of an
    in-range value is exact on every device, so the card and the CPU agree."""
    safe = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, F32_BELOW_2_31)
    return torch.where(x >= 2.0**31, I32_MAX, safe.to(I32))


def dot(a, b):
    """Dot product over the last axis, summed left to right (the order the
    reference's short reduction takes)."""
    prod = a * b
    out = prod[..., 0]
    for i in range(1, prod.shape[-1]):
        out = out + prod[..., i]
    return out


def cross(a, b):
    """Cross product in the reference's op order (a1*b2 - a2*b1, ...)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    """sqrt(dot(v, v)), correctly rounded (ATen's CPU float sqrt is not: the
    f64 sqrt rounded once to f32 is, as ops/shading.sqrt_exact)."""
    d = dot(v, v)
    return torch.sqrt(d.double()).to(d.dtype)


def normalize(v):
    # FORMULAS.md: true divide + sqrt, no rsqrt fast path (oracle parity).
    return v / length(v)[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def homogenize(p3):
    """[..., 3] points -> [..., 4] with w=1."""
    ones = torch.ones(p3.shape[:-1] + (1,), dtype=p3.dtype, device=p3.device)
    return torch.cat([p3, ones], dim=-1)


def identity(*, device):
    return torch.eye(4, dtype=F32, device=device)


def translate(t, *, device):
    m = torch.eye(4, dtype=F32, device=device)
    m[:3, 3] = torch.as_tensor(t, dtype=F32, device=device)
    return m


def scale(s, *, device):
    s = torch.as_tensor(s, dtype=F32, device=device).expand(3)
    return torch.diag(torch.cat([s, torch.ones(1, dtype=F32, device=device)]))


def _rotation(theta, device, rows):
    """rows: 4x4 nested list of 0, 1, 'c', 's' or '-s' entries.

    cos/sin are taken in f32 on the host and the matrix is then copied to
    `device`, so a rotation has the same bits on every device (the card's
    cosf and the CPU's cos may differ in the last ulp)."""
    theta = torch.as_tensor(theta, dtype=F32).cpu()
    c, s = torch.cos(theta), torch.sin(theta)
    one = torch.ones((), dtype=F32)
    zero = torch.zeros((), dtype=F32)
    pick = {0: zero, 1: one, "c": c, "s": s, "-s": -s}
    return torch.stack([torch.stack([pick[e] for e in row])
                        for row in rows]).to(device)


def rotate_x(theta, *, device):
    return _rotation(theta, device, [[1, 0, 0, 0], [0, "c", "-s", 0],
                                     [0, "s", "c", 0], [0, 0, 0, 1]])


def rotate_y(theta, *, device):
    return _rotation(theta, device, [["c", 0, "s", 0], [0, 1, 0, 0],
                                     ["-s", 0, "c", 0], [0, 0, 0, 1]])


def rotate_z(theta, *, device):
    return _rotation(theta, device, [["c", "-s", 0, 0], ["s", "c", 0, 0],
                                     [0, 0, 1, 0], [0, 0, 0, 1]])


def rotate_axis(axis, theta, *, device):
    """Rodrigues rotation about a (not necessarily unit) axis; built on the
    host in f32 and copied to `device`, as the other rotations."""
    x, y, z = normalize(torch.as_tensor(axis, dtype=F32).cpu())
    theta = torch.as_tensor(theta, dtype=F32).cpu()
    c, s = torch.cos(theta), torch.sin(theta)
    C = 1.0 - c
    m = torch.eye(4, dtype=F32)
    m[:3, :3] = torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s]),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s]),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C]),
    ])
    return m.to(device)


def perspective(fov_y_rad, aspect, z_near, z_far, *, device):
    """OpenGL-style right-handed perspective; maps z to NDC [-1, 1]. The
    entries are computed in float64 on the host and rounded once to f32, as
    the JAX reference does."""
    f = 1.0 / np.tan(float(fov_y_rad) / 2.0)
    zn, zf = float(z_near), float(z_far)
    return torch.tensor(
        [
            [f / float(aspect), 0, 0, 0],
            [0, f, 0, 0],
            [0, 0, (zf + zn) / (zn - zf), (2.0 * zf * zn) / (zn - zf)],
            [0, 0, -1, 0],
        ],
        dtype=F32, device=device,
    )


def orthographic(left, right, bottom, top, z_near, z_far, *, device):
    """OpenGL-style orthographic projection; entries in float64 on the host,
    rounded once to f32."""
    l, r, b, t, zn, zf = map(float, (left, right, bottom, top, z_near, z_far))
    return torch.tensor(
        [
            [2.0 / (r - l), 0, 0, -(r + l) / (r - l)],
            [0, 2.0 / (t - b), 0, -(t + b) / (t - b)],
            [0, 0, -2.0 / (zf - zn), -(zf + zn) / (zf - zn)],
            [0, 0, 0, 1],
        ],
        dtype=F32, device=device,
    )


def look_at(eye, target, up, *, device):
    """World -> view matrix of a camera at `eye` looking at `target`."""
    eye = torch.as_tensor(eye, dtype=F32, device=device)
    fwd = normalize(torch.as_tensor(target, dtype=F32, device=device) - eye)
    right = normalize(cross(fwd, torch.as_tensor(up, dtype=F32,
                                                 device=device)))
    up2 = cross(right, fwd)
    rot = torch.stack([right, up2, -fwd])  # world -> view rotation rows
    m = torch.eye(4, dtype=F32, device=device)
    m[:3, :3] = rot
    # explicit mat3 . vec in the reference's order (see mat4mul for why)
    m[:3, 3] = -(rot[:, 0] * eye[0] + rot[:, 1] * eye[1] + rot[:, 2] * eye[2])
    return m


def mat4mul(a, b):
    """Exact 4x4 composition in fixed op order (FORMULAS.md):
    out_ij = (a_i0*b_0j + a_i1*b_1j) + (a_i2*b_2j + a_i3*b_3j).
    Chains left-assoc: mat4mul(mat4mul(T, R), S)."""
    return (a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :]) + (
        a[:, 2:3] * b[2:3, :] + a[:, 3:4] * b[3:4, :]
    )


def transform_points(points4, mat4):
    """Batched v' = M @ v for points [..., 4]:
    out_i = (m_i0*x + m_i1*y) + (m_i2*z + m_i3*w)."""
    x = points4[..., 0:1]
    y = points4[..., 1:2]
    z = points4[..., 2:3]
    w = points4[..., 3:4]
    m = mat4
    return torch.cat(
        [(m[i, 0] * x + m[i, 1] * y) + (m[i, 2] * z + m[i, 3] * w)
         for i in range(4)],
        dim=-1,
    )


def transform_directions(dirs3, mat4):
    """Rotate/scale [..., 3] directions by the upper 3x3 (no translation)."""
    x = dirs3[..., 0:1]
    y = dirs3[..., 1:2]
    z = dirs3[..., 2:3]
    m = mat4
    return torch.cat(
        [(m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z for i in range(3)],
        dim=-1,
    )


def model_matrix(position=(0.0, 0.0, 0.0), rotation=None, scale_v=1.0, *,
                 device):
    """T @ R @ S (the reference's per-mesh pos/rotation/scale submit)."""
    r = identity(device=device) if rotation is None else rotation
    return mat4mul(mat4mul(translate(position, device=device), r),
                   scale(scale_v, device=device))

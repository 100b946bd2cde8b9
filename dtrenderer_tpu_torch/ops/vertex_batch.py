"""The vertex stage and packing of a run of draws, in one batched pass.

`pipeline.pack_draws` gives a run of DrawSpecs (an opaque run of
draw_meshes, or the one draw of draw_mesh "fused" and of draw_mesh_ordered
"tile") to this module; draw_mesh "pallas" and "ref" and draw_mesh_ordered
"scan" stage their one draw through `pack`, the eager pass. The draws are
not looped over: the vertex arrays of the draws that share a shading mode
are concatenated, each draw's faces
offset by its vertex base, and every per-draw value (mvp, normal and model
matrix, colour, payload head) is a row indexed by each vertex's or
triangle's draw. A run of one draw broadcasts its one row instead. Every
element goes through the ops of `pipeline.prepare_draw` and
`render_fused.pack_payload` in FORMULAS.md's order (explicit broadcasts, no
matmul), so the batch equals their per-draw composition bit for bit, with
triangles in draw order, then face order, each clipped pair interleaved.

The pass is cut into three parts, so that ops/vertex_graph.py can capture
the last one in a CUDA graph and replay it:

- `plan_run`: what the submission's key fixes, made once, on the device:
  the draws' grouping by shading mode, the index rows, the payload head
  rows, the texture LUT's layout, the bbox constants, and the per-draw
  table the kernel reads (`TABLE_*` columns: first triangle, mode, the
  meshes' addresses and strides, the offsets of each draw's matrices and
  colour in the frame vector);
- `frame_inputs`: what changes from frame to frame (view_proj, the draws'
  model, normal and mvp matrices, the light, the colours), as the tensors
  and host values of one f32 vector (`frame_vector` joins them);
- `run_pass(plan, vec, draws)`: device ops only, with no host synchronise
  and no host-to-device copy. It reads the draws' meshes and textures where
  they lie.

On a CUDA plan `run_pass` launches the hand-written kernel
csrc/vertex_pass.cu (one thread per source triangle: gather, transform,
light, near clip, setup and packing in registers) and counts it in
`KERNEL_LAUNCHES`; on a CPU plan it runs `run_pass_plain`, the same
function in plain torch (the element-wise pass described above), to which
the kernel is held bit for bit. There is no fallback between the two: any
other device raises, and so does a mesh the kernel does not read (it takes
f32 verts, uv and normals and i64 or i32 faces, at any strides).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtrenderer_tpu_torch.ops import geometry
from dtrenderer_tpu_torch.ops.pipeline import DrawBatch, corner_attrs_with_q
from dtrenderer_tpu_torch.ops.render_fused import (
    CORNER_STRIDE, PAYLOAD_CHANNELS, make_texture_lut, pack_flags,
)
from dtrenderer_tpu_torch.ops.shading import (
    SHADING_FLAT, SHADING_GOURAUD, SHADING_NONE, SHADING_PHONG, Light,
    apply_light, light_term,
)
from dtrenderer_tpu_torch.utils.math3d import cross

F32 = torch.float32
# the order in which the mode groups are concatenated before `perm`
MODES = (SHADING_FLAT, SHADING_GOURAUD, SHADING_PHONG, SHADING_NONE)
# the kernel's code of each mode (csrc/vertex_pass.cu kFlat, ...)
MODE_CODES = {mode: i for i, mode in enumerate(MODES)}

# The per-draw table, i64 [n_draws, TABLE_COLS] (csrc/vertex_pass.cu kCols):
# the draw's first triangle in the run and its triangles, its mode code,
# 1 if its faces are i32 (else i64), the addresses of its verts, uv,
# normals and faces, their (row, column) element strides in that order, its
# vertices, and the offsets in the frame vector of its model matrix, its
# normal matrix and its colour. Columns TABLE_MESH are what its mesh gives.
(TABLE_FIRST, TABLE_TRIS, TABLE_MODE, TABLE_FACES_I32, TABLE_PTRS,
 TABLE_STRIDES, TABLE_NVERTS, TABLE_MODEL, TABLE_NORMAL,
 TABLE_COLOR) = (0, 1, 2, 3, 4, 8, 16, 17, 18, 19)
TABLE_COLS = 20
TABLE_MESH = slice(TABLE_FACES_I32, TABLE_NVERTS + 1)
MESH_WIDTHS = (("verts", 3), ("uv", 2), ("normals", 3), ("faces", 3))

# Kernel launches made by run_pass (CUDA plans only; a launch that a CUDA
# graph captures is not one: its replays are vertex_graph.REPLAYS).
KERNEL_LAUNCHES = 0


class Group(NamedTuple):
    """The draws of one shading mode, in draw order. vrow / trow: each
    vertex's / triangle's draw (an index into the per-draw rows), and
    fbase: each triangle's first vertex of its draw within the group
    ([T, 1], added to the concatenated faces); all None for a group of one
    draw, whose row is broadcast and whose faces are used as they are."""
    shading: str
    draws: tuple
    vrow: torch.Tensor | None
    trow: torch.Tensor | None
    fbase: torch.Tensor | None


class RunPlan(NamedTuple):
    """What the key of a run fixes (ops/vertex_graph.submission_key)."""
    device: torch.device
    n_draws: int
    n_rows: int                # setup rows T' (2T with the near clip)
    frame_w: int
    frame_h: int
    cull_backfaces: bool
    near_clip: bool
    groups: tuple
    perm: torch.Tensor | None  # draw-order triangle -> row of the groups
    n_normals: int             # normal matrices given apart from the model
    normal_row: torch.Tensor | None  # each draw's normal matrix in `mats`
    mvps_given: bool
    host_colors: tuple         # draws whose colour comes from the host
    color_row: torch.Tensor | None   # each draw's row in the colour block
    head: torch.Tensor         # [T', 4] payload heads, or [1, 4] broadcast
    white: torch.Tensor        # the texture of an untextured draw, [1, 1, 4]
    step_and_hi: torch.Tensor  # geometry.bbox_steps
    rows: tuple                # the per-draw table (TABLE_*), on the host
    table: torch.Tensor        # the same, i64 [n_draws, TABLE_COLS]
    heads: torch.Tensor        # each draw's payload head, f32 [n_draws, 4]

    @property
    def n_tris(self) -> int:
        """Source triangles (one thread each in the kernel)."""
        return self.n_rows // (2 if self.near_clip else 1)

    @property
    def n_mats(self) -> int:
        return 1 + self.n_draws + self.n_normals + (
            self.n_draws if self.mvps_given else 0)

    @property
    def light_at(self) -> int:
        return 16 * self.n_mats

    @property
    def n_inputs(self) -> int:
        return self.light_at + 4 + 4 * self.n_draws


def color_on(color, device) -> bool:
    """True when a draw's colour is a tensor on the run's device (it then
    joins the device part of the frame vector; any other colour is read on
    the host)."""
    return torch.is_tensor(color) and color.device == device


def _rows(counts, device):
    """[sum(counts)] i64: entry i repeated counts[i] times, or None for a
    single entry."""
    if len(counts) == 1:
        return None
    return torch.repeat_interleave(torch.arange(len(counts)),
                                   torch.tensor(counts)).to(device)


def plan_run(draws, sampling_mode: str, frame_w: int, frame_h: int,
             cull_backfaces: bool, near_clip: bool, mvps_given: bool,
             device) -> RunPlan:
    """Build the RunPlan of a run of DrawSpecs on `device` (host work and
    a few small host-to-device copies; no per-frame value is read)."""
    n = len(draws)
    for d in draws:
        if d.shading not in MODES:
            raise ValueError(f"unknown shading mode {d.shading!r}")
    n_tris = [int(d.mesh.faces.shape[0]) for d in draws]
    per_tri = 2 if near_clip else 1

    groups, order = [], []
    for mode in MODES:
        ids = tuple(i for i, d in enumerate(draws) if d.shading == mode)
        if not ids:
            continue
        nv = [int(draws[i].mesh.verts.shape[0]) for i in ids]
        vrow = _rows(nv, device)
        trow = _rows([n_tris[i] for i in ids], device)
        fbase = None
        if vrow is not None:  # group-local rows -> the run's draw rows
            fbase = torch.tensor(np.cumsum([0] + nv[:-1]),
                                 device=device)[trow, None]
            idx = torch.tensor(ids, device=device)
            vrow, trow = idx[vrow], idx[trow]
        groups.append(Group(mode, ids, vrow, trow, fbase))
        order.extend(ids)
    perm = None
    if len(groups) > 1:  # the groups' rows are in `order`; put them back
        start = dict(zip(order, np.cumsum([0] + [n_tris[i]
                                                 for i in order[:-1]])))
        perm = torch.from_numpy(np.concatenate(
            [np.arange(start[i], start[i] + n_tris[i]) for i in range(n)])
        ).to(device)

    normals = [i for i, d in enumerate(draws) if d.normal_mat is not None]
    normal_rows = list(range(1, 1 + n))
    for k, i in enumerate(normals):
        normal_rows[i] = 1 + n + k
    normal_row = None
    if normals:
        normal_row = torch.tensor(normal_rows, device=device)

    host = tuple(i for i, d in enumerate(draws)
                 if not color_on(d.color, device))
    color_rows = list(range(n))
    color_row = None
    if 0 < len(host) < n:
        block = [i for i in range(n) if i not in host] + list(host)
        color_rows = np.argsort(block).tolist()
        color_row = torch.tensor(color_rows, device=device)

    white = torch.ones((1, 1, 4), dtype=F32, device=device)
    _, meta = make_texture_lut(_textures(draws, white))
    heads = [(*m, pack_flags(d.shading == SHADING_PHONG,
                             (d.sampling or sampling_mode) == "bilinear"))
             for d, m in zip(draws, meta)]
    head = torch.tensor(heads, dtype=F32)
    if n > 1:
        head = head.repeat_interleave(
            torch.tensor([per_tri * t for t in n_tris]), dim=0)

    n_mats = 1 + n + len(normals) + (n if mvps_given else 0)
    colors_at = 16 * n_mats + 4  # the light's 4 values, then the colours
    first = np.cumsum([0] + n_tris[:-1]).tolist()
    rows = tuple(
        (first[i], n_tris[i], MODE_CODES[d.shading], *mesh_columns(d.mesh),
         16 * (1 + i), 16 * normal_rows[i], colors_at + 4 * color_rows[i])
        for i, d in enumerate(draws))

    return RunPlan(
        device=device, n_draws=n, n_rows=per_tri * sum(n_tris),
        frame_w=int(frame_w), frame_h=int(frame_h),
        cull_backfaces=bool(cull_backfaces), near_clip=bool(near_clip),
        groups=tuple(groups), perm=perm, n_normals=len(normals),
        normal_row=normal_row, mvps_given=mvps_given, host_colors=host,
        color_row=color_row, head=head.to(device), white=white,
        step_and_hi=geometry.bbox_steps(frame_w, frame_h, device), rows=rows,
        table=torch.tensor(rows, dtype=torch.int64).reshape(
            n, TABLE_COLS).to(device),
        heads=torch.tensor(heads, dtype=F32).reshape(n, 4).to(device))


def mesh_columns(mesh) -> tuple:
    """A mesh's columns of the per-draw table (TABLE_MESH): 1 if its faces
    are i32, the addresses of verts, uv, normals and faces, their (row,
    column) strides, its vertices."""
    ts = [getattr(mesh, name) for name, _ in MESH_WIDTHS]
    strides = [(tuple(t.stride()) + (0, 0))[:2] for t in ts]
    return (int(mesh.faces.dtype == torch.int32),
            *(t.data_ptr() for t in ts), *(s for st in strides for s in st),
            int(mesh.verts.shape[0]))


def check_draws(plan: RunPlan, draws):
    """Raise unless the draws are what the kernel reads: as many as the
    plan's, on its device, each mesh of f32 verts [N, 3], uv [N, 2] and
    normals [N, 3], and i64 or i32 faces [T, 3], at any strides."""
    if len(draws) != plan.n_draws:
        raise ValueError(f"{len(draws)} draws for a plan of {plan.n_draws}")
    for i, d in enumerate(draws):
        n_verts = d.mesh.verts.shape[0]
        for name, width in MESH_WIDTHS:
            t = getattr(d.mesh, name)
            is_faces = name == "faces"
            kinds = (torch.int64, torch.int32) if is_faces else (F32,)
            if t.dtype not in kinds or t.dim() != 2 or t.shape[1] != width \
                    or (not is_faces and t.shape[0] != n_verts):
                raise ValueError(
                    f"draw {i}: mesh.{name} must be "
                    f"{'i64 or i32 [T' if is_faces else f'f32 [{n_verts}'}, "
                    f"{width}], got {t.dtype} {tuple(t.shape)}")
            if t.device != plan.device:
                raise ValueError(f"draw {i}: mesh.{name} is on {t.device}, "
                                 f"the plan on {plan.device}")


def _textures(draws, white):
    """Each draw's texture, `white` for an untextured one (one object, so
    make_texture_lut stores it once)."""
    return [d.texture if d.texture is not None else white for d in draws]


def frame_inputs(plan: RunPlan, draws, view_proj, light: Light, mvps=None):
    """(tensors, host values) of one frame's vector: the tensors, flattened
    and joined in this order, fill its device part (view_proj, the models,
    the normal matrices given, the mvps given, the light's direction and
    ambient, the colours on the device); the host values, f32 [4 * k], its
    last 4 * k entries (the other colours)."""
    dev = [view_proj, *(d.model for d in draws),
           *(d.normal_mat for d in draws if d.normal_mat is not None)]
    if plan.mvps_given:
        dev.extend(mvps)
    dev += [light.direction, light.ambient]
    host = [draws[i].color for i in plan.host_colors]
    dev += [d.color for i, d in enumerate(draws) if i not in plan.host_colors]
    values = np.asarray(
        [np.asarray(c.detach().cpu() if torch.is_tensor(c) else c,
                    np.float32).reshape(4) for c in host],
        np.float32).reshape(-1)
    return [t.reshape(-1) for t in dev], torch.from_numpy(values)


def frame_vector(plan: RunPlan, draws, view_proj, light: Light, mvps=None):
    """One frame's input vector, f32 [plan.n_inputs], on the plan's
    device."""
    tensors, host = frame_inputs(plan, draws, view_proj, light, mvps)
    return torch.cat(tensors + [host.to(plan.device)])


def _mat4mul_rows(a, b):
    """math3d.mat4mul(a, b[i]) for every row i of b [R, 4, 4] at once."""
    return (a[:, 0:1] * b[:, 0:1, :] + a[:, 1:2] * b[:, 1:2, :]) + (
        a[:, 2:3] * b[:, 2:3, :] + a[:, 3:4] * b[:, 3:4, :])


def _points(p3, m, rows: int = 4):
    """math3d.transform_points(homogenize(p3), m) with one matrix per point
    (m [N, 4, 4]) or one for all (m [1, 4, 4]); the first `rows` outputs.
    The w = 1 term is m_i3 itself (m_i3 * 1 rounds to m_i3)."""
    x, y, z = p3[:, 0:1], p3[:, 1:2], p3[:, 2:3]
    return torch.cat(
        [(m[:, i, 0:1] * x + m[:, i, 1:2] * y) + (m[:, i, 2:3] * z
                                                  + m[:, i, 3:4])
         for i in range(rows)], dim=-1)


def _directions(d3, m):
    """math3d.transform_directions with one matrix per row (or one)."""
    x, y, z = d3[:, 0:1], d3[:, 1:2], d3[:, 2:3]
    return torch.cat([(m[:, i, 0:1] * x + m[:, i, 1:2] * y) + m[:, i, 2:3] * z
                      for i in range(3)], dim=-1)


def _cat(tensors):
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors)


def _group_corners(g: Group, meshes, mvps, models, normal_mats, colors,
                   light: Light):
    """pipeline.gather_corner_data over one mode group: (corners_clip
    [T, 3, 4], raw [T, 3, 9]) of its draws' triangles, in draw order."""
    def row(per_draw, index):  # per-draw rows for every vertex / triangle
        if index is None:
            return per_draw[g.draws[0]:g.draws[0] + 1]
        return per_draw[index]

    ms = [meshes[i] for i in g.draws]
    verts = _cat([m.verts for m in ms])
    faces = _cat([m.faces for m in ms])
    if g.fbase is not None:
        faces = faces + g.fbase
    n_v, n_t = verts.shape[0], faces.shape[0]
    cols = [_points(verts, row(mvps, g.vrow)), _cat([m.uv for m in ms])]
    if g.shading == SHADING_FLAT:
        cols.append(_points(verts, row(models, g.vrow), 3))
    elif g.shading in (SHADING_GOURAUD, SHADING_PHONG):
        n = _directions(_cat([m.normals for m in ms]),
                        row(normal_mats, g.vrow))
        if g.shading == SHADING_GOURAUD:
            n = apply_light(row(colors, g.vrow).expand(n_v, 4),
                            light_term(n, light))
        cols.append(n)
    gathered = torch.cat(cols, dim=-1)[faces]  # [T, 3, D]

    color_t = row(colors, g.trow)[:, None].expand(n_t, 3, 4)
    nq = torch.zeros((n_t, 3, 3), dtype=F32, device=verts.device)
    if g.shading == SHADING_FLAT:
        w0, w1, w2 = (gathered[:, k, 6:9] for k in range(3))
        term = light_term(cross(w1 - w0, w2 - w0), light)
        rgba = apply_light(color_t, term[:, None])
    elif g.shading == SHADING_GOURAUD:
        rgba = gathered[..., 6:10]
    else:
        rgba = color_t
        if g.shading == SHADING_PHONG:
            nq = gathered[..., 6:9]
    raw = torch.cat([gathered[..., 4:6], rgba, nq], dim=-1)
    return gathered[..., 0:4], raw


def _mvps(plan: RunPlan, mats):
    """Each draw's mvp, [n_draws, 4, 4]: the ones given, else
    view_proj @ model."""
    n = plan.n_draws
    if plan.mvps_given:
        return mats[1 + n + plan.n_normals:]
    return _mat4mul_rows(mats[0], mats[1:1 + n])


def run_pass(plan: RunPlan, vec, draws) -> DrawBatch:
    """The vertex stage and packing of the run: DrawBatch of its T' setup
    rows, from the frame vector `vec` and the draws' meshes and textures.
    One launch of csrc/vertex_pass.cu on a CUDA plan, run_pass_plain on a
    CPU plan."""
    global KERNEL_LAUNCHES
    if plan.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"run_pass runs on CUDA (kernel) or CPU (plain twin), not "
            f"{plan.device.type}")
    check_draws(plan, draws)
    if plan.device.type == "cpu":
        return run_pass_plain(plan, vec, draws)
    if tuple(r[TABLE_MESH] for r in plan.rows) != tuple(
            mesh_columns(d.mesh) for d in draws):
        raise ValueError("the draws' meshes are not where the plan's table "
                         "says (plan_run them again)")
    if vec.dtype != F32 or vec.device != plan.device or \
            vec.shape != (plan.n_inputs,) or not vec.is_contiguous():
        raise ValueError(f"vec must be a contiguous f32 [{plan.n_inputs}] on "
                         f"{plan.device}, got {vec.dtype} {tuple(vec.shape)}")
    from dtrenderer_tpu_torch.kernels import vertex_pass as kv

    dev, rows = plan.device, plan.n_rows
    mvps = _mvps(plan, vec[:16 * plan.n_mats].view(plan.n_mats, 4, 4))
    coef = torch.empty((rows, geometry.SETUP_CHANNELS), dtype=F32,
                       device=dev)
    bbox = torch.empty((rows, 4), dtype=torch.int32, device=dev)
    valid = torch.empty(rows, dtype=torch.bool, device=dev)
    payload = torch.empty((rows, PAYLOAD_CHANNELS), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        kv.launch(plan.table, plan.heads, vec, mvps.contiguous(), coef, bbox,
                  valid, payload, plan.n_tris, plan.light_at, plan.frame_w,
                  plan.frame_h, plan.cull_backfaces, plan.near_clip)
        if rows and not torch.cuda.is_current_stream_capturing():
            KERNEL_LAUNCHES += 1
    lut, _ = make_texture_lut(_textures(draws, plan.white))
    return DrawBatch(coef, bbox, valid, payload, lut)


def run_pass_plain(plan: RunPlan, vec, draws) -> DrawBatch:
    """run_pass in plain torch: the element-wise pass over the mode groups
    (the CPU path, and the twin the kernel is held to on the card)."""
    n = plan.n_draws
    mats = vec[:16 * plan.n_mats].view(plan.n_mats, 4, 4)
    view_proj, models = mats[0], mats[1:1 + n]
    normal_mats = (models if plan.normal_row is None
                   else mats[plan.normal_row])
    mvps = (mats[1 + n + plan.n_normals:] if plan.mvps_given
            else _mat4mul_rows(view_proj, models))
    at = plan.light_at
    light = Light(direction=vec[at:at + 3], ambient=vec[at + 3])
    colors = vec[at + 4:at + 4 + 4 * n].view(n, 4)
    if plan.color_row is not None:
        colors = colors[plan.color_row]

    meshes = [d.mesh for d in draws]
    parts = [_group_corners(g, meshes, mvps, models, normal_mats, colors,
                            light) for g in plan.groups]
    corners_clip = _cat([c for c, _ in parts])
    raw = _cat([r for _, r in parts])
    if plan.perm is not None:
        corners_clip, raw = corners_clip[plan.perm], raw[plan.perm]

    pre_valid = None
    if plan.near_clip:
        clip2, attrs2, valid2 = geometry.clip_near(corners_clip, raw)
        corners_clip = clip2.reshape(plan.n_rows, 3, 4)
        raw = attrs2.reshape(plan.n_rows, 3, 9)
        pre_valid = valid2.reshape(plan.n_rows)
    screen_c = geometry.corners_to_screen(corners_clip, plan.frame_w,
                                          plan.frame_h)
    setup = geometry.setup_with_steps(
        screen_c[:, 0], screen_c[:, 1], screen_c[:, 2], plan.frame_w,
        plan.frame_h, plan.cull_backfaces, plan.step_and_hi)
    valid = setup.valid if pre_valid is None else setup.valid & pre_valid
    attrs10 = corner_attrs_with_q(screen_c, raw)
    payload = torch.cat(
        [plan.head.expand(plan.n_rows, 4),
         attrs10.reshape(plan.n_rows, 3 * CORNER_STRIDE)], dim=1)

    lut, _ = make_texture_lut(_textures(draws, plan.white))
    return DrawBatch(setup.coef, setup.bbox, valid, payload, lut)


def pack(draws, view_proj, light: Light, sampling_mode: str, frame_w: int,
         frame_h: int, cull_backfaces: bool = True, near_clip: bool = True,
         mvps=None) -> DrawBatch:
    """The batched pass, eager: plan, frame vector and pass in one call, as
    pipeline.pack_draws takes them. It is what pack_draws runs on the CPU,
    the graph's first sighting of a key on the card, and the vertex stage
    of the "pallas", "ref" and "scan" routes (pipeline._stage)."""
    plan = plan_run(draws, sampling_mode, frame_w, frame_h, cull_backfaces,
                    near_clip, mvps is not None, light.direction.device)
    return run_pass(plan, frame_vector(plan, draws, view_proj, light, mvps),
                    draws)

"""The vertex-stage kernel (csrc/vertex_pass.cu) and its host side in
ops/vertex_batch.py.

Bars:
  * the per-draw table that `plan_run` builds (first triangles, mode codes,
    the meshes' addresses and strides, the offsets of each draw's model
    matrix, normal matrix and colour in the frame vector, the payload
    heads) for one draw, for four draws of three modes with a normal matrix
    given and colours on the host and on the device, and with the near clip
    on and off;
  * `run_pass` on a CPU plan is `run_pass_plain`, bit for bit, over the
    cases of tests/test_torch_vertex_batch.py, and the batch still equals
    the per-draw composition there;
  * the wrapper raises, with no fallback, on a mesh it does not read (a
    dtype, a width, a device) and on a device that is neither CPU nor CUDA;
  * csrc/vertex_pass.cu itself, compiled for the host with g++ and a few
    shims (one OS thread per CUDA thread of a block, a barrier for
    __syncwarp), equals `run_pass_plain` bit for bit (NaN at the same
    places) on those cases, every case of models/edge_cases.py and the
    shapes of models/stress.py in the four shading modes: the kernel's
    arithmetic, table reads and staged stores, checked without a card
    (skipped where there is no g++);
  * nothing of the new modules imports JAX or the JAX package;
  * on the card (`gpu`): the kernel against its twin on the edge cases and
    the stress shapes, and a mesh changed in place between two replays of
    a captured key (python -m pytest --noconftest -m gpu
    tests/test_torch_vertex_pass.py).
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.models.mesh import Mesh
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops import vertex_batch as vb
from dtrenderer_tpu_torch.ops import vertex_graph
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3

import test_torch_vertex_batch as tvb  # its scene, cases and per-draw stage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
W, H = 96, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(device, t=0.6):
    """Four draws of three modes: a flat textured cube, a Gouraud sphere
    with a tensor colour and a normal matrix given, a Phong plane through
    the near plane, a Gouraud cube with a host colour."""
    cube = pprim.cube(device=device)
    tex = pprim.checkerboard(16, 4, device=device)

    def mm(pos, angle, s=1.0):
        return pm3.model_matrix(pos, pm3.rotate_y(angle, device=device), s,
                                device=device)

    proj = pm3.perspective(np.pi / 3, W / H, 0.1, 50.0, device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    sphere = ppipe.DrawSpec(
        pprim.uv_sphere(6, 8, device=device), mm((0.8, -0.4, -3.5), -t, 0.8),
        color=torch.tensor([0.3, 0.9, 0.5, 1.0], device=device))
    sphere.normal_mat = pm3.mat4mul(sphere.model, pm3.scale(
        (1.0, 2.0, 0.5), device=device))
    draws = [
        ppipe.DrawSpec(cube, mm((-1.2, 0.3, -4.0), t), texture=tex,
                       shading="flat", color=(0.9, 0.8, 0.7, 1.0)),
        sphere,
        ppipe.DrawSpec(pprim.plane(1.5, device=device),
                       mm((0.2, -0.5, -0.5), t, 3.0), shading="phong",
                       sampling="nearest", color=(0.6, 0.6, 1.0, 1.0)),
        ppipe.DrawSpec(cube, mm((-0.5, -0.8, -2.5), 1.3 * t, 0.4),
                       color=(1.0, 0.5, 0.2, 1.0)),
    ]
    return proj, light, draws


def _plan(draws, near_clip=True, mvps_given=False, cull=True):
    return vb.plan_run(draws, "bilinear", W, H, cull, near_clip, mvps_given,
                       CPU)


def _mesh_cols(mesh):
    """The table's mesh columns, written out from the tensors."""
    ts = (mesh.verts, mesh.uv, mesh.normals, mesh.faces)
    return [int(mesh.faces.dtype == torch.int32),
            *(t.data_ptr() for t in ts),
            *(s for t in ts for s in t.stride()), mesh.verts.shape[0]]


# ---------------------------------------------------------- the table


def test_the_table_of_one_draw():
    proj, light, draws = _scene(CPU)
    d = draws[0]
    plan = _plan([d])
    assert plan.table.dtype == torch.int64
    assert plan.table.shape == (1, vb.TABLE_COLS)
    n_tris = d.mesh.faces.shape[0]
    # vec: view_proj, the model, the light (4), the colour
    assert plan.table[0].tolist() == [
        0, n_tris, vb.MODE_CODES["flat"], *_mesh_cols(d.mesh), 16, 16,
        plan.light_at + 4]
    assert plan.light_at == 32 and plan.n_tris == n_tris
    assert plan.n_rows == 2 * n_tris
    assert plan.heads.tolist() == [[0.0, 16.0, 16.0, prf.pack_flags(
        False, True)]]
    assert tuple(map(tuple, plan.table.tolist())) == plan.rows


def test_the_table_of_four_draws_of_three_modes():
    proj, light, draws = _scene(CPU)
    plan = _plan(draws)
    n_tris = [d.mesh.faces.shape[0] for d in draws]
    t = plan.table
    assert t[:, vb.TABLE_FIRST].tolist() == np.cumsum([0] + n_tris[:-1]) \
        .tolist()
    assert t[:, vb.TABLE_TRIS].tolist() == n_tris
    assert t[:, vb.TABLE_MODE].tolist() == [
        vb.MODE_CODES[m] for m in ("flat", "gouraud", "phong", "gouraud")]
    for i, d in enumerate(draws):
        assert t[i, vb.TABLE_MESH].tolist() == _mesh_cols(d.mesh)
    # vec: view_proj, 4 models, the sphere's normal matrix, light, colours
    assert t[:, vb.TABLE_MODEL].tolist() == [16, 32, 48, 64]
    assert t[:, vb.TABLE_NORMAL].tolist() == [16, 80, 48, 64]
    assert plan.light_at == 96
    # the sphere's colour is on the device: first in the colour block
    assert t[:, vb.TABLE_COLOR].tolist() == [104, 100, 108, 112]
    vec = vb.frame_vector(plan, draws, proj, light)
    for i, d in enumerate(draws):
        model_at, normal_at, color_at = t[i, vb.TABLE_MODEL:].tolist()
        assert torch.equal(vec[model_at:model_at + 16], d.model.reshape(-1))
        normal = d.normal_mat if d.normal_mat is not None else d.model
        assert torch.equal(vec[normal_at:normal_at + 16], normal.reshape(-1))
        assert torch.equal(vec[color_at:color_at + 4], torch.as_tensor(
            d.color, dtype=torch.float32).reshape(-1))
    # the heads: each draw's texture placement and flags, the plain pass's
    heads = plan.head[t[:, vb.TABLE_FIRST] * 2]
    assert torch.equal(plan.heads, heads)
    assert plan.heads[:, 3].tolist() == [
        prf.pack_flags(False, True), prf.pack_flags(False, True),
        prf.pack_flags(True, False), prf.pack_flags(False, True)]


@pytest.mark.parametrize("near_clip", [True, False])
def test_the_table_with_the_near_clip_on_and_off(near_clip):
    proj, light, draws = _scene(CPU)
    plan = _plan(draws, near_clip=near_clip)
    other = _plan(draws, near_clip=not near_clip)
    n = sum(d.mesh.faces.shape[0] for d in draws)
    assert plan.n_tris == n
    assert plan.n_rows == (2 * n if near_clip else n)
    assert torch.equal(plan.table, other.table)
    assert torch.equal(plan.heads, other.heads)


def test_given_mvps_shift_the_light_and_colours():
    proj, light, draws = _scene(CPU)
    plan = _plan(draws, mvps_given=True)
    # view_proj, 4 models, 1 normal matrix, 4 mvps
    assert plan.light_at == 16 * 10
    assert plan.table[:, vb.TABLE_COLOR].tolist() == [168, 164, 172, 176]


# ------------------------------------------------------- dispatch, CPU


def _case_inputs(case):
    """(draws, view_proj, light, pack_draws keywords) of a case of
    tests/test_torch_vertex_batch.py."""
    opts = dict(tvb.CASES[case])
    proj, light, draws = tvb._scene(CPU)
    if "pick" in opts:
        draws = [draws[i] for i in opts.pop("pick")]
    if opts.pop("normals", False):
        draws = tvb._normals_given(draws, CPU)
    if opts.pop("mvps", False):
        opts["mvps"] = [pm3.mat4mul(proj, pm3.mat4mul(
            d.model, pm3.translate((0.0, 0.05 * i, 0.0), device=CPU)))
            for i, d in enumerate(draws)]
    return draws, proj, light, {"cull_backfaces": True, "near_clip": True,
                                **opts}


@pytest.mark.parametrize("case", sorted(tvb.CASES))
def test_run_pass_on_the_cpu_is_the_plain_pass(case):
    draws, proj, light, kw = _case_inputs(case)
    mvps = kw.get("mvps")
    plan = vb.plan_run(draws, "bilinear", W, H, kw["cull_backfaces"],
                       kw["near_clip"], mvps is not None, CPU)
    vec = vb.frame_vector(plan, draws, proj, light, mvps)
    got = vb.run_pass(plan, vec, draws)
    tvb.assert_same_batch(got, vb.run_pass_plain(plan, vec, draws))
    tvb.assert_same_batch(got, tvb.per_draw(draws, proj, light, "bilinear",
                                            W, H, **kw))
    assert vb.KERNEL_LAUNCHES == 0  # the CPU never launches


def _bad(mesh, **fields):
    return Mesh(**{**mesh._asdict(), **fields})


@pytest.mark.parametrize("field, value, match", [
    ("verts", lambda m: m.verts.double(), "verts must be f32"),
    ("uv", lambda m: m.uv.half(), "uv must be f32"),
    ("normals", lambda m: m.normals[:, :2], "normals must be f32"),
    ("faces", lambda m: m.faces.to(torch.int16), "faces must be i64 or i32"),
    ("faces", lambda m: m.faces.float(), "faces must be i64 or i32"),
    ("uv", lambda m: m.uv[:-1], "uv must be f32"),
])
def test_the_wrapper_raises_on_a_mesh_it_does_not_read(field, value, match):
    proj, light, draws = _scene(CPU)
    plan = _plan(draws)
    vec = vb.frame_vector(plan, draws, proj, light)
    draws[2].mesh = _bad(draws[2].mesh, **{field: value(draws[2].mesh)})
    with pytest.raises(ValueError, match=match):
        vb.run_pass(plan, vec, draws)


def test_the_wrapper_raises_on_other_devices_with_no_fallback():
    proj, light, draws = _scene(CPU)
    plan = _plan(draws)
    vec = vb.frame_vector(plan, draws, proj, light)
    with pytest.raises(NotImplementedError, match="not meta"):
        vb.run_pass(plan._replace(device=torch.device("meta")), vec, draws)
    # a CUDA plan does not take meshes on the CPU (no copy, no fallback)
    with pytest.raises(ValueError, match="is on cpu, the plan on cuda"):
        vb.run_pass(plan._replace(device=torch.device("cuda", 0)), vec, draws)
    with pytest.raises(ValueError, match="3 draws for a plan of 4"):
        vb.run_pass(plan, vec, draws[:3])


def test_i32_faces_are_read_as_the_plain_pass_reads_them():
    proj, light, draws = _scene(CPU)
    draws[3].mesh = _bad(draws[3].mesh,
                         faces=draws[3].mesh.faces.to(torch.int32))
    plan = _plan(draws)
    assert plan.table[:, vb.TABLE_FACES_I32].tolist() == [0, 0, 0, 1]
    vec = vb.frame_vector(plan, draws, proj, light)
    tvb.assert_same_batch(vb.run_pass(plan, vec, draws),
                          vb.run_pass_plain(plan, vec, draws))


def test_the_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import dtrenderer_tpu_torch.kernels.vertex_pass\n"
        "import dtrenderer_tpu_torch.ops.vertex_batch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'dtrenderer_tpu' or m.startswith('dtrenderer_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for rel in ("dtrenderer_tpu_torch/kernels/vertex_pass.py",
                "dtrenderer_tpu_torch/ops/vertex_batch.py"):
        with open(os.path.join(REPO, rel)) as f:
            assert "jax" not in f.read(), rel


# ------------------------------------------- the kernel source on the host

# What nvcc gives the kernel and g++ does not: CUDA's vector types, the
# correctly rounded sqrt, the launch's indices (one OS thread per CUDA
# thread of a block), the dynamic shared memory and __syncwarp.
HOST_SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx;
static thread_local dim3 threadIdx;
static float* host_smem;
static std::barrier<>* host_warp[32];
inline void __syncwarp() { host_warp[threadIdx.x >> 5]->arrive_and_wait(); }
using std::isnan; using std::isfinite; using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
extern "C" void host_vertex_pass(
    const int64_t* table, const float* heads, int n_draws, int64_t n_tris,
    const float* vec, const float* mvps, int light_at, int width, int height,
    int cull, int near_clip, float* coef, int* bbox, bool* valid,
    float* payload) {
  std::vector<float> smem((kThreads / 32) * 64 * kRowWords, NAN);
  host_smem = smem.data();
  for (int w = 0; w < kThreads / 32; ++w) host_warp[w] = new std::barrier<>(32);
  for (int64_t b = 0; b * kThreads < n_tris; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < kThreads; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        vertex_pass_kernel(table, reinterpret_cast<const float4*>(heads),
                           n_draws, n_tris, vec, mvps, light_at, width,
                           height, cull, near_clip, coef, bbox, valid,
                           payload);
      });
    for (auto& th : threads) th.join();
  }
  for (int w = 0; w < kThreads / 32; ++w) delete host_warp[w];
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/vertex_pass.cu built for the host: its device code with
    HOST_SHIM in place of the CUDA runtime, HOST_LAUNCH in place of the
    launch, no FMA contraction and no fast math."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(os.path.join(REPO, "dtrenderer_tpu_torch", "csrc",
                           "vertex_pass.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", HOST_SHIM)
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = host_smem;")
    src = src[:src.index('extern "C" cudaError_t dtr_vertex_pass(')]
    out = tmp_path_factory.mktemp("vertex_pass_host")
    cpp, lib = out / "vertex_pass_host.cpp", out / "vertex_pass_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-pthread", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.host_vertex_pass.argtypes = [p, p, i, ll, p, p, i, i, i, i, i, p, p,
                                     p, p]

    def run(plan, vec, draws):
        vb.check_draws(plan, draws)
        mvps = vb._mvps(plan, vec[:16 * plan.n_mats].view(
            plan.n_mats, 4, 4)).contiguous()
        rows = plan.n_rows
        out = ppipe.DrawBatch(
            torch.full((rows, 16), 7.0), torch.full((rows, 4), 7,
                                                    dtype=torch.int32),
            torch.ones(rows, dtype=torch.bool), torch.full((rows, 34), 7.0),
            prf.make_texture_lut(vb._textures(draws, plan.white))[0])
        dll.host_vertex_pass(
            plan.table.data_ptr(), plan.heads.data_ptr(), plan.n_draws,
            plan.n_tris, vec.data_ptr(), mvps.data_ptr(), plan.light_at,
            plan.frame_w, plan.frame_h, int(plan.cull_backfaces),
            int(plan.near_clip), out.coef.data_ptr(), out.bbox.data_ptr(),
            out.valid.data_ptr(), out.payload.data_ptr())
        return out

    return run


def assert_same_batch_nan(got, want):
    """Every field bit-equal; a NaN may be any NaN, at the same places."""
    for name, g, r in zip(ppipe.DrawBatch._fields, got, want):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype == torch.float32:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(r)), name
            g = torch.where(nan, 0, g.view(torch.int32))
            r = torch.where(nan, 0, r.view(torch.int32))
        assert torch.equal(g, r), (
            f"{name} differs at {int((g != r).sum())} elements")


def _against_plain(run, draws, proj, light, sampling, w, h, cull, near,
                   mvps=None):
    plan = vb.plan_run(draws, sampling, w, h, cull, near, mvps is not None,
                       draws[0].mesh.verts.device)
    vec = vb.frame_vector(plan, draws, proj, light, mvps)
    want = vb.run_pass_plain(plan, vec, draws)
    assert_same_batch_nan(run(plan, vec, draws), want)
    return want


@pytest.mark.parametrize("case", sorted(tvb.CASES))
def test_the_kernel_source_on_the_host_equals_the_plain_pass(host_kernel,
                                                             case):
    draws, proj, light, kw = _case_inputs(case)
    want = _against_plain(host_kernel, draws, proj, light, "bilinear", W, H,
                          kw["cull_backfaces"], kw["near_clip"],
                          kw.get("mvps"))
    assert int(want.valid.sum()) > 0


@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_the_kernel_source_on_the_host_on_the_edge_cases(host_kernel, name):
    c = ec.CASES[name]()
    _against_plain(host_kernel, ec.draw_specs(c, CPU),
                   torch.from_numpy(c.view_proj),
                   make_light(*ec.LIGHT, device=CPU), "nearest", c.width,
                   c.height, c.cull_backfaces, c.near_clip)


@pytest.mark.parametrize("name", sorted(stress.CASES))
def test_the_kernel_source_on_the_host_on_the_stress_shapes(host_kernel,
                                                            name):
    corners, h, w = stress.CASES[name]()
    mesh = stress.mesh_of_corners(corners, h, w, CPU)
    eye = torch.eye(4)
    draws = [ppipe.DrawSpec(mesh, eye, shading=mode,
                            color=(0.9, 0.6, 0.3, 1.0))
             for mode in ("flat", "gouraud", "phong", "none")]
    want = _against_plain(host_kernel, draws, eye,
                          make_light(*ec.LIGHT, device=CPU), "nearest", w, h,
                          False, True)
    assert int(want.valid.sum()) == 4 * int(
        stress.setup(corners, h, w, CPU).valid.sum())


# --------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_the_kernel_equals_its_twin_on_the_edge_cases(name):
    dev = _card()
    c = ec.CASES[name]()

    def run(plan, vec, draws):
        return vb.run_pass(plan, vec, draws)

    before = vb.KERNEL_LAUNCHES
    _against_plain(run, ec.draw_specs(c, dev),
                   torch.from_numpy(c.view_proj).to(dev),
                   make_light(*ec.LIGHT, device=dev), "nearest", c.width,
                   c.height, c.cull_backfaces, c.near_clip)
    assert vb.KERNEL_LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(stress.CASES))
def test_the_kernel_equals_its_twin_on_the_stress_shapes(name):
    dev = _card()
    corners, h, w = stress.CASES[name]()
    mesh = stress.mesh_of_corners(corners, h, w, dev)
    eye = torch.eye(4, device=dev)
    draws = [ppipe.DrawSpec(mesh, eye, shading=mode,
                            color=(0.9, 0.6, 0.3, 1.0))
             for mode in ("flat", "gouraud", "phong", "none")]
    _against_plain(lambda *a: vb.run_pass(*a), draws, eye,
                   make_light(*ec.LIGHT, device=dev), "nearest", w, h, False,
                   True)


@pytest.mark.gpu
def test_a_mesh_changed_in_place_between_two_replays():
    dev = _card()
    vertex_graph.reset()
    proj, light, draws = _scene(dev)

    def packed():
        return ppipe.DrawBatch(*(t.clone() for t in ppipe.pack_draws(
            draws, proj, light, "bilinear", W, H)))

    for _ in range(3):  # eager, captured, replayed
        first = packed()
    draws[1].mesh.verts.mul_(1.25)
    draws[3].mesh.normals.mul_(-1.0)
    second = packed()
    assert vertex_graph.REPLAYS == 3
    assert not torch.equal(first.coef, second.coef)
    plan = vb.plan_run(draws, "bilinear", W, H, True, True, False, dev)
    assert_same_batch_nan(second, vb.run_pass_plain(
        plan, vb.frame_vector(plan, draws, proj, light), draws))

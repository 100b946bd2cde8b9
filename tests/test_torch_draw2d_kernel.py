"""The 2D verb kernel, csrc/draw2d.cu (D2), held to its twins.

Bars:
  * csrc/draw2d.cu itself, compiled for the host with g++ and a few shims
    (the launch's indices, run one pixel after another: a per-pixel kernel
    needs no barrier) and driven through kernels/draw2d.py's own wrapper,
    equals the plain torch path bit for bit (NaN at the same places) for
    every case of models/draw2d_cases.py: every verb kind, the edge windows,
    both text layouts at scale 1 and 2 and strings longer than one launch
    takes (ops/draw2d.py draw_plain, ops/text.py coverage_plain), and every
    render_triangle case's G-buffer and rows (triangle_gbuffer_plain); the
    input plane unwritten and every pixel of the output written (skipped
    where there is no g++);
  * glyph_cells equals ops/text.py's cell arithmetic in torch int32;
  * nothing of the new modules imports JAX or the JAX package;
  * on the card (`gpu`): the same cases through draw2d.draw and
    draw2d.triangle against the plain path on the same inputs, each verb
    one launch (python -m pytest --noconftest -m gpu
    tests/test_torch_draw2d_kernel.py).
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch.assets.font import FIRST_CHAR, GRID_COLS
from dtrenderer_tpu_torch.kernels import draw2d as kd
from dtrenderer_tpu_torch.models import draw2d_cases as cases
from dtrenderer_tpu_torch.ops import draw2d
from dtrenderer_tpu_torch.ops.fb import Framebuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H, W = 40, 72


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(got, want, name):
    """Bit-equal; a NaN may be any NaN, at the same places."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if want.dtype == torch.int32:
        assert torch.equal(got, want), name
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), name
    assert torch.equal(torch.where(nan, 0, got.view(torch.int32)),
                       torch.where(nan, 0, want.view(torch.int32))), name


# ------------------------------------------- the kernel source on the host

# What nvcc gives the kernel and g++ does not: CUDA's vector type, __ldg,
# IEEE divide and sqrt by name, the launch's indices; the visibility walk's
# shared arrays and warp and block primitives (raster_common.cuh compiles
# them; D2 calls none of them).
HOST_SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx;
inline void __syncthreads() { std::abort(); }
inline unsigned __ballot_sync(unsigned, bool) { std::abort(); }
inline int __ffs(int) { std::abort(); }
using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
template <typename F> static void run_frame(int height, int width, F&& f) {
  if (height <= 0 || width <= 0) return;
  const unsigned nb = blocks_of(height, width);
  for (unsigned b = 0; b < nb; ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < kBlock; ++t) { threadIdx.x = t; f(); }
  }
}
extern "C" int dtr_draw2d_shape(int kind, const float* p, const float* in,
                                float* out, int height, int width,
                                const int* win, void*) {
  const Shape s = make_shape(kind, p);
  run_frame(height, width, [&] {
    shape_kernel(s, reinterpret_cast<const float4*>(in),
                 reinterpret_cast<float4*>(out), region(win), height, width);
  });
  return 0;
}
extern "C" int dtr_draw2d_blit(const float* p, const float* image, int bh,
                               int bw, const float* in, float* out,
                               int height, int width, const int* win, void*) {
  const Blit b = make_blit(p, bh, bw);
  run_frame(height, width, [&] {
    blit_kernel(b, reinterpret_cast<const float4*>(image),
                reinterpret_cast<const float4*>(in),
                reinterpret_cast<float4*>(out), region(win), height, width);
  });
  return 0;
}
extern "C" int dtr_draw2d_text(const float* color, const int* ints,
                               const int* ox, const int* oy,
                               const float* bounds, const float* atlas,
                               const float* in, float* out, int height,
                               int width, const int* win, void*) {
  if (ints[5] < 1 || ints[5] > kMaxGlyphs) return 1;
  const Text t = make_text(color, ints, ox, oy, bounds);
  run_frame(height, width, [&] {
    text_kernel(t, atlas, reinterpret_cast<const float4*>(in),
                reinterpret_cast<float4*>(out), region(win), height, width);
  });
  return 0;
}
extern "C" int dtr_draw2d_triangle(const float* coef, const float* attrs,
                                   float* z, int* tri, float* coef_out,
                                   float* attrs_out, int height, int width,
                                   const int* win, void*) {
  const Triangle t = make_triangle(coef, attrs);
  run_frame(height, width, [&] {
    triangle_kernel(t, z, tri, coef_out, attrs_out, region(win), height,
                    width);
  });
  return 0;
}
extern "C" int dtr_draw2d_max_glyphs() { return kMaxGlyphs; }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/draw2d.cu built for the host: raster_common.cuh inlined with
    HOST_SHIM in place of the CUDA runtime, HOST_LAUNCH in place of the
    launches, no FMA contraction and no fast math; bound as
    kernels/draw2d.py binds the card's build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    csrc = os.path.join(REPO, "dtrenderer_tpu_torch", "csrc")
    with open(os.path.join(csrc, "raster_common.cuh")) as f:
        header = f.read().replace("#include <cuda_runtime.h>", HOST_SHIM)
    with open(os.path.join(csrc, "draw2d.cu")) as f:
        src = f.read()
    src = src.replace('#include "raster_common.cuh"', header)
    src = src[:src.index("// Plain C entry points")]
    out = tmp_path_factory.mktemp("draw2d_host")
    cpp, lib = out / "draw2d_host.cpp", out / "draw2d_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    kd.bind(dll)
    return dll


def host_draw(lib, fb, verb):
    """draw2d.draw's card path over the host build, into an output filled
    with a sentinel (every pixel must be written)."""
    if verb.window.empty:
        return fb
    color = fb.color.contiguous()
    out = torch.full_like(color, 7.0)
    kd.launch(verb, color, out, lib=lib)
    return Framebuffer(out, fb.depth)


VERBS = {c.name: c for c in cases.verb_cases(H, W, CPU, seed=11)}
TRIANGLES = {c.name: c for c in cases.triangle_cases(H, W, seed=11)}


@pytest.mark.parametrize("name", sorted(VERBS))
def test_the_kernel_source_on_the_host_equals_the_plain_verb(host_lib, name):
    fb = cases.framebuffer(H, W, CPU, seed=4)
    before = fb.color.clone()
    verb = VERBS[name].make(fb)
    want = draw2d.draw_plain(fb, verb)
    got = host_draw(host_lib, fb, verb)
    assert_same(got.color, want.color, name)
    assert torch.equal(before.view(torch.int32), fb.color.view(torch.int32))


@pytest.mark.parametrize("name", sorted(TRIANGLES))
def test_the_kernel_source_on_the_host_equals_the_plain_gbuffer(host_lib,
                                                               name):
    case = TRIANGLES[name]
    coef, bbox, valid = draw2d.setup_host(case.corners[:, :4], W, H,
                                          case.cull_backfaces)
    if not valid:  # nothing to draw: no G-buffer, the framebuffer back
        fb = cases.framebuffer(H, W, CPU, seed=4)
        assert draw2d.triangle(fb, case.corners, None, case.sampling,
                               case.cull_backfaces) is fb
        return
    win = draw2d.Window(bbox[1], bbox[3] + 1, bbox[0], bbox[2] + 1)
    attrs = draw2d.corner_attrs_host(case.corners)
    z = torch.full((H, W), 7.0)
    tri = torch.full((H, W), 7, dtype=torch.int32)
    coef_out = torch.full((1, 16), 7.0)
    attrs_out = torch.full((1, 3, 10), 7.0)
    kd.triangle(coef, attrs, win, z, tri, coef_out, attrs_out, lib=host_lib)
    zw, tw = draw2d.triangle_gbuffer_plain(torch.from_numpy(coef[None]), win,
                                           H, W)
    assert_same(z, zw, name)
    assert_same(tri, tw, name)
    assert_same(coef_out, torch.from_numpy(coef[None]), name)
    assert_same(attrs_out, torch.from_numpy(attrs[None]), name)


def test_the_cases_cover_every_kind_and_both_launch_paths_of_text():
    fb = cases.framebuffer(H, W, CPU, seed=4)
    kinds = {VERBS[n].make(fb).kind for n in VERBS}
    assert kinds == set(range(7))
    long = [VERBS[n].make(fb) for n in VERBS if "longer than" in n]
    assert len(long) == 2 and all(v.text.codes.shape[0] > 256 for v in long)


def test_glyph_cells_equal_the_torch_int32_arithmetic():
    codes = np.array([32, 65, 126, 0, 31, 127, 300, -5, -2 ** 31,
                      2 ** 31 - 1], np.int32)
    ox, oy = kd.glyph_cells(codes, 7, 14)
    code = torch.from_numpy(codes) - FIRST_CHAR
    np.testing.assert_array_equal(ox, ((code % GRID_COLS) * 7).numpy())
    np.testing.assert_array_equal(oy, ((code // GRID_COLS) * 14).numpy())


def test_the_new_modules_import_no_jax():
    code = ("import sys; import dtrenderer_tpu_torch.kernels.draw2d, "
            "dtrenderer_tpu_torch.ops.draw2d, dtrenderer_tpu_torch.ops.text, "
            "dtrenderer_tpu_torch.models.draw2d_cases; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'dtrenderer_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_the_kernel_equals_its_twin_on_the_card():
    dev = _card()
    fb = cases.framebuffer(H, W, dev, seed=4)
    for case in cases.verb_cases(H, W, dev, seed=11):
        verb = case.make(fb)
        before = draw2d.KERNEL_LAUNCHES
        got = draw2d.draw(fb, verb)
        launches = draw2d.KERNEL_LAUNCHES - before
        assert launches == (0 if verb.window.empty else
                            -(-verb.text.codes.shape[0] // 256)
                            if verb.kind == draw2d.TEXT else 1), case.name
        assert_same(got.color, draw2d.draw_plain(fb, verb).color, case.name)
    tex = torch.ones((4, 4, 4), device=dev)
    for case in cases.triangle_cases(H, W, seed=11):
        got = draw2d.triangle(fb, case.corners, tex, case.sampling,
                              case.cull_backfaces)
        cpu = Framebuffer(fb.color.cpu(), fb.depth.cpu())
        want = draw2d.triangle(cpu, case.corners, tex.cpu(), case.sampling,
                               case.cull_backfaces)
        assert_same(got.color, want.color, case.name)
        assert_same(got.depth, want.depth, case.name)

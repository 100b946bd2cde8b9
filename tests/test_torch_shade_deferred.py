"""The deferred shading pass: csrc/shade_deferred.cu (DS) and its host side,
ops/pipeline.py shade_deferred, whose CPU path is shade_deferred_plain.

Bars:
  * csrc/shade_deferred.cu itself, compiled for the host with g++ and a few
    shims (the launch's indices, run one pixel after another: a per-pixel
    kernel needs no barrier), equals shade_deferred_plain bit for bit (NaN
    at the same places), with the attribute rows 30 floats apart (a tensor
    of their own) and 34 (StagedDraw.attrs10, a view of the vertex pass's
    payload), with the framebuffer's depth seeded so that only
    some covered pixels win (ties lose), over Gouraud, Phong and "none",
    nearest and bilinear, a textured draw and the white texture, shards at
    non-zero offsets, every case of models/edge_cases.py and the inputs of
    api.render_triangle (skipped where there is no g++);
  * on the CPU shade_deferred is shade_deferred_plain, launches nothing and
    leaves the framebuffer it was given as it was; another device raises;
  * shade_deferred_plain against the JAX package's shade_deferred
    (dtrenderer_tpu/ops/pipeline.py) on the same numpy inputs: depth bit
    for bit, colour within FMA-contraction noise;
  * nothing of the new modules imports JAX or the JAX package;
  * on the card (`gpu`): DS against its twin on the same inputs, at both
    attribute row strides, strided shard planes and a texture view at an
    offset included, and fb
    untouched (python -m pytest --noconftest -m gpu
    tests/test_torch_shade_deferred.py).
"""

import ctypes
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch import api
from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.models import primitives as pprim
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops.raster_ref import rasterize_ref
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils import math3d as pm3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H, W = 48, 64

# (shading, sampling, textured): every mode of the pass
DRAW_CASES = [(s, m, t) for s in ("gouraud", "phong", "none")
              for m in ("nearest", "bilinear") for t in (True, False)]
# shards (y0, x0, h, w) of the H x W frame
SHARDS = [(16, 8, 24, 40), (5, 37, 30, 27)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool. Values do not depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- inputs


def _seeded_fb(z, seed):
    """A framebuffer whose depth lets only some covered pixels win: +inf
    (the pixel wins), z itself (a tie: it loses) or a uniform depth."""
    rng = np.random.default_rng(seed)
    h, w = z.shape
    zn = z.cpu().numpy()
    u = rng.uniform(0, 1, (h, w))
    depth = np.where(u < 0.4, np.inf, np.where(
        u < 0.7, zn, rng.uniform(0, 1, (h, w)))).astype(np.float32)
    color = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    return pfb.Framebuffer(torch.from_numpy(color).to(z.device),
                           torch.from_numpy(depth).to(z.device))


def _staged_inputs(staged, fb_h, fb_w, y0, x0, seed):
    """shade_deferred's keyword arguments for one staged "ref" draw over the
    [fb_h, fb_w] shard at (y0, x0)."""
    setup = staged.setup
    z, tri = rasterize_ref(setup.coef, setup.valid, fb_h, fb_w,
                           y_offset=y0, x_offset=x0)
    return dict(fb=_seeded_fb(z, seed), z=z, tri=tri, coef=setup.coef,
                attrs=staged.attrs10, texture=staged.texture,
                sampling_mode=staged.sampling_mode,
                shading_mode=staged.shading, light=staged.light,
                y_offset=y0, x_offset=x0)


def draw_inputs(shading, sampling, textured, device, shard=None, seed=3):
    """A sphere, staged on backend "ref" for the H x W frame, rastered over
    `shard` (the whole frame when None)."""
    y0, x0, h, w = shard or (0, 0, H, W)
    proj = pm3.perspective(1.0, W / H, 0.1, 20.0, device=device)
    model = pm3.model_matrix((0.2, -0.1, -3.2), pm3.mat4mul(
        pm3.rotate_y(0.7, device=device), pm3.rotate_x(0.4, device=device)),
        device=device)
    tex = (pprim.checkerboard(16, 4, (1.0, 0.6, 0.2, 1.0),
                              (0.1, 0.3, 0.9, 0.8), device=device)
           if textured else None)
    staged = ppipe.stage_draw_mesh(
        device, pprim.uv_sphere(10, 14, device=device), model, proj, H, W,
        texture=tex, light=make_light((0.4, 0.6, 1.0), 0.15, device=device),
        color=(0.9, 0.8, 0.7, 0.9), shading=shading, sampling_mode=sampling,
        backend="ref")
    return _staged_inputs(staged, h, w, y0, x0, seed)


def edge_case_inputs(name, device):
    """Per draw of an edge case, shade_deferred's arguments on "ref"."""
    case = ec.CASES[name]()
    light = make_light(*ec.LIGHT, device=device)
    view_proj = torch.from_numpy(case.view_proj).to(device)
    out = []
    for i, s in enumerate(ec.draw_specs(case, device)):
        staged = ppipe.stage_draw_mesh(
            device, s.mesh, s.model, view_proj, case.height, case.width,
            texture=s.texture, light=light, color=s.color,
            shading=s.shading, sampling_mode=s.sampling,
            cull_backfaces=case.cull_backfaces, near_clip=case.near_clip)
        out.append(_staged_inputs(staged, case.height, case.width, 0, 0,
                                  11 + i))
    return out


def triangle_inputs(textured, device):
    """The arguments api.render_triangle hands shade_deferred: a textured
    bilinear triangle with per-corner q over a cleared state, or the
    untextured one (a [1, 1, 4] texture of ones, zero normals)."""
    seen = []
    plain = ppipe.shade_deferred_plain

    def capture(*args):
        seen.append(args)
        return plain(*args)

    state = api.clear(api.new_state(W, H, device=device),
                      (0.1, 0.2, 0.3, 1.0))
    tex = pprim.checkerboard(8, 4, (1, 0.5, 0.1, 0.9), (0.1, 0.3, 1.0, 0.9),
                             device=device) if textured else None
    with mock.patch.object(ppipe, "shade_deferred", capture):
        api.render_triangle(state, (4, 3, 0.3, 1.0), (60, 12, 0.6, 0.5),
                            (15, 45, 0.2, 0.25), color=(1, 1, 1, 0.9),
                            uv0=(0, 1), uv1=(1, 1), uv2=(0, 0), texture=tex,
                            sampling_mode="bilinear" if textured
                            else "nearest")
    (fb, z, tri, coef, attrs, texture, sampling, shading, light), = seen
    return dict(fb=_seeded_fb(z, 5), z=z, tri=tri, coef=coef, attrs=attrs,
                texture=texture, sampling_mode=sampling,
                shading_mode=shading, light=light)


def _cases():
    """{name: device -> [shade_deferred kwargs, one per draw]}."""
    out = {}
    for s, m, t in DRAW_CASES:
        out[f"{s} {m} {'textured' if t else 'white'}"] = (
            lambda dev, s=s, m=m, t=t: [draw_inputs(s, m, t, dev)])
    for shard in SHARDS:
        out[f"phong bilinear shard {shard}"] = (
            lambda dev, shard=shard: [draw_inputs("phong", "bilinear", True,
                                                  dev, shard)])
    for name in ec.CASES:
        out[f"edge case {name}"] = (
            lambda dev, name=name: edge_case_inputs(name, dev))
    for textured in (True, False):
        out[f"render_triangle textured={textured}"] = (
            lambda dev, textured=textured: [triangle_inputs(textured, dev)])
    return out


CASES = _cases()


def assert_same_fb(got, want):
    """Colour and depth bit-equal; a NaN may be any NaN, at the same
    places."""
    for name in ("color", "depth"):
        g, r = getattr(got, name).cpu(), getattr(want, name).cpu()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(g), nan), name
        g = torch.where(nan, 0, g.view(torch.int32))
        r = torch.where(nan, 0, r.view(torch.int32))
        assert torch.equal(g, r), (
            f"{name} differs at {int((g != r).sum())} elements")


def wins(kw):
    """(winning pixels, covered pixels) of one call's inputs."""
    covered = kw["tri"] >= 0
    return (int((covered & (kw["z"] < kw["fb"].depth)).sum()),
            int(covered.sum()))


def test_every_case_has_winners_and_losers():
    """The seeded depth leaves some covered pixels winning and some losing
    in each case that covers a pixel."""
    for name, make in CASES.items():
        calls = make(CPU)
        won = sum(wins(kw)[0] for kw in calls)
        covered = sum(wins(kw)[1] for kw in calls)
        if covered:
            assert 0 < won < covered, name


# ------------------------------------------- the kernel source on the host

# What nvcc gives the kernel and g++ does not: CUDA's vector type, __ldg,
# the launch's indices; the visibility walk's shared arrays and warp and
# block primitives (raster_common.cuh compiles them; the deferred kernel
# calls none of them).
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
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx;
inline void __syncthreads() { std::abort(); }
inline unsigned __ballot_sync(unsigned, bool) { std::abort(); }
inline int __ffs(int) { std::abort(); }
using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
extern "C" void host_shade_deferred(
    const float* z, const int* tri, const float* depth, const float* color,
    const float* coef, const float* attrs, const float* tex_lut,
    const float* scalars, float* out_color, float* out_depth, float tw,
    float th, float flags, int tex_len, int attrs_stride, int height,
    int width, int y_offset, int x_offset) {
  const size_t n = static_cast<size_t>(height) * width;
  for (size_t b = 0; b * kBlock < n; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    for (unsigned t = 0; t < kBlock; ++t) {
      threadIdx.x = t;
      shade_deferred_kernel(
          z, tri, depth, reinterpret_cast<const float4*>(color), coef, attrs,
          reinterpret_cast<const float4*>(tex_lut), scalars,
          reinterpret_cast<float4*>(out_color), out_depth,
          make_float4(0.0f, tw, th, flags), tex_len, attrs_stride, height,
          width, y_offset, x_offset);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/shade_deferred.cu built for the host: raster_common.cuh inlined
    with HOST_SHIM in place of the CUDA runtime, HOST_LAUNCH in place of the
    launch, no FMA contraction and no fast math. Returns shade_deferred's
    counterpart over the host build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    csrc = os.path.join(REPO, "dtrenderer_tpu_torch", "csrc")
    with open(os.path.join(csrc, "raster_common.cuh")) as f:
        header = f.read().replace("#include <cuda_runtime.h>", HOST_SHIM)
    with open(os.path.join(csrc, "shade_deferred.cu")) as f:
        src = f.read()
    src = src.replace('#include "raster_common.cuh"', header)
    src = src[:src.index('extern "C" cudaError_t dtr_shade_deferred(')]
    out = tmp_path_factory.mktemp("shade_deferred_host")
    cpp, lib = out / "shade_deferred_host.cpp", out / "shade_deferred_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.host_shade_deferred.argtypes = [p] * 10 + [f, f, f] + [i] * 6

    def run(fb, z, tri, coef, attrs, texture, sampling_mode, shading_mode,
            light, y_offset=0, x_offset=0):
        """attrs is read at its own row stride (its rows' 30 channels
        contiguous), as the wrapper hands it to the kernel."""
        h, w = fb.depth.shape
        th, tw = texture.shape[0], texture.shape[1]
        assert attrs.stride()[1:] == (10, 1) and attrs.stride(0) >= 30
        ins = [t.contiguous() for t in (z, tri, fb.depth, fb.color, coef)]
        ins.append(attrs)
        lut = texture.contiguous().reshape(th * tw, 4)
        scalars = prf.light_scalars(light)
        out = pfb.Framebuffer(torch.full((h, w, 4), 7.0),
                              torch.full((h, w), 7.0))
        dll.host_shade_deferred(
            *(t.data_ptr() for t in ins), lut.data_ptr(), scalars.data_ptr(),
            out.color.data_ptr(), out.depth.data_ptr(), float(tw), float(th),
            prf.pack_flags(shading_mode == "phong",
                           sampling_mode == "bilinear"),
            th * tw, attrs.stride(0), h, w, y_offset, x_offset)
        return out

    return run


def with_row_stride(attrs, stride: int):
    """attrs [T, 3, 10] as a view whose rows lie `stride` floats apart
    (30: a tensor of its own; 34: the corner channels of a DrawBatch's
    payload, as StagedDraw.attrs10 is); the floats between rows are NaN."""
    T = attrs.shape[0]
    buf = torch.full((T, stride), float("nan"), device=attrs.device)
    buf[:, stride - 30:] = attrs.reshape(T, 30)
    return buf.as_strided((T, 3, 10), (stride, 10, 1), stride - 30)


@pytest.mark.parametrize("stride", [30, 34])
@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernel_source_on_the_host_equals_the_plain_pass(host_kernel,
                                                             name, stride):
    for kw in CASES[name](CPU):
        kw["attrs"] = with_row_stride(kw["attrs"], stride)
        before = [t.clone() for t in kw["fb"]]
        assert_same_fb(host_kernel(**kw), ppipe.shade_deferred_plain(**kw))
        assert all(torch.equal(a, b) for a, b in zip(before, kw["fb"]))


# ---------------------------------------------------------- CPU dispatch


@pytest.mark.parametrize("name", ["phong bilinear textured",
                                  "edge case nonfinite_uvs",
                                  "phong bilinear shard (16, 8, 24, 40)"])
def test_on_the_cpu_the_pass_is_the_plain_twin_and_pure(name):
    for kw in CASES[name](CPU):
        before = [t.clone() for t in kw["fb"]]
        launches = ppipe.KERNEL_LAUNCHES
        got = ppipe.shade_deferred(**kw)
        assert ppipe.KERNEL_LAUNCHES == launches
        assert_same_fb(got, ppipe.shade_deferred_plain(**kw))
        for a, b in zip(before, kw["fb"]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_another_device_raises():
    kw = draw_inputs("gouraud", "nearest", False, CPU)
    kw["fb"] = pfb.Framebuffer(kw["fb"].color.to("meta"),
                               kw["fb"].depth.to("meta"))
    with pytest.raises(NotImplementedError, match="CUDA"):
        ppipe.shade_deferred(**kw)


# --------------------------------------------------- against the reference


@pytest.mark.parametrize("shading,sampling,textured,shard", [
    ("phong", "bilinear", True, None),
    ("gouraud", "nearest", True, SHARDS[1]),
    ("none", "bilinear", False, None),
])
def test_plain_pass_matches_the_jax_reference(shading, sampling, textured,
                                              shard):
    """The same numpy inputs through dtrenderer_tpu's shade_deferred (its
    attrs padded to the reference's 16 channels): depth bit for bit (a
    select), colour within the FMA-contraction noise of XLA:CPU, packed u8
    within +-1 with no outliers."""
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu.ops.fb import Framebuffer as JFramebuffer
    from dtrenderer_tpu.ops.shading import Light as JLight
    from dtrenderer_tpu.utils.color import pack_srgb_u8 as jpack
    from dtrenderer_tpu_torch.utils.color import pack_srgb_u8 as ppack

    kw = draw_inputs(shading, sampling, textured, CPU, shard)
    want = ppipe.shade_deferred_plain(**kw)
    a = kw["attrs"].numpy()
    attrs16 = np.zeros((a.shape[0], 3, jpipe.ATTR_CHANNELS), np.float32)
    attrs16[..., :a.shape[2]] = a
    light = kw["light"]
    ref = jpipe.shade_deferred(
        JFramebuffer(jnp.asarray(kw["fb"].color.numpy()),
                     jnp.asarray(kw["fb"].depth.numpy())),
        jnp.asarray(kw["z"].numpy()), jnp.asarray(kw["tri"].numpy()),
        jnp.asarray(kw["coef"].numpy()), jnp.asarray(attrs16),
        jnp.asarray(kw["texture"].numpy()), sampling, shading,
        JLight(jnp.asarray(light.direction.numpy()),
               jnp.asarray(light.ambient.numpy())),
        kw["y_offset"], kw["x_offset"])
    np.testing.assert_array_equal(np.asarray(ref.depth).view(np.int32),
                                  want.depth.numpy().view(np.int32))
    err = np.abs(np.asarray(ref.color) - want.color.numpy()).max()
    assert err <= 1e-5, err
    du8 = np.abs(np.asarray(jpack(ref.color)).astype(int)
                 - ppack(want.color).numpy().astype(int))
    assert du8.max() <= 1
    assert wins(kw)[0] > 50


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import dtrenderer_tpu_torch.kernels.shade_deferred\n"
        "import dtrenderer_tpu_torch.ops.pipeline\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'dtrenderer_tpu' or m.startswith('dtrenderer_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    with open(os.path.join(REPO, "dtrenderer_tpu_torch", "kernels",
                           "shade_deferred.py")) as f:
        assert "jax" not in f.read()


# --------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [30, 34])
@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernel_equals_its_twin_on_the_card(name, stride):
    dev = _card()
    for kw in CASES[name](dev):
        kw["attrs"] = with_row_stride(kw["attrs"], stride)
        before = [t.clone() for t in kw["fb"]]
        launches = ppipe.KERNEL_LAUNCHES
        got = ppipe.shade_deferred(**kw)
        assert ppipe.KERNEL_LAUNCHES == launches + 1
        assert_same_fb(got, ppipe.shade_deferred_plain(**kw))
        for a, b in zip(before, kw["fb"]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_strided_planes_and_a_texture_view_on_the_card():
    """A column shard's planes are strided views of the frame's, and a
    texture may be a view at an offset: the wrapper copies them into
    contiguous, aligned planes and shades the same bits."""
    dev = _card()
    kw = draw_inputs("phong", "bilinear", True, dev, SHARDS[0])
    y0, x0, h, w = SHARDS[0]
    big = pfb.Framebuffer(torch.zeros((H, W, 4), device=dev),
                          torch.zeros((H, W), device=dev))
    big.color[y0:y0 + h, x0:x0 + w] = kw["fb"].color
    big.depth[y0:y0 + h, x0:x0 + w] = kw["fb"].depth
    tex = kw["texture"]
    padded = torch.zeros((tex.numel() + 3,), device=dev)
    padded[3:] = tex.reshape(-1)
    view = dict(kw, fb=pfb.Framebuffer(big.color[y0:y0 + h, x0:x0 + w],
                                       big.depth[y0:y0 + h, x0:x0 + w]),
                texture=padded[3:].view(tex.shape))
    assert not view["fb"].color.is_contiguous()
    assert view["texture"].data_ptr() % 16
    assert_same_fb(ppipe.shade_deferred(**view),
                   ppipe.shade_deferred_plain(**kw))

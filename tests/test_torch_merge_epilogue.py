"""The depth merge in K1's epilogue: `render_fused(..., fb=...)` rasterizes,
shades and merges into fresh framebuffer planes in one launch of
csrc/render_fused.cu; `render_fused_plain(..., fb=...)` is its twin, the
draw call's torch merge (win = z < fb.depth, then two `where`s over
utils/color.blend_over).

Bars:
  * the twin's merge equals the torch merge over its own (z, src) bit for
    bit (NaN at the same places), with the winners' count, through
    render_fused's CPU dispatch too and into preallocated `out` planes;
  * a banded frame whose launches write row views of one pair of planes
    equals the `torch.cat` of its bands, counters included;
  * draw_meshes and draw_mesh on backend "fused" (config 4 small, an edge
    case) against the JAX package within ARCHITECTURE.md's bar (same covered
    pixels, depth within 1e-4 relative, packed u8 within +-1, rare explained
    near-ties and near-edges);
  * the framebuffer the caller passed is never written;
  * csrc/render_fused.cu itself, compiled for the host with g++ and shims
    (one OS thread per CUDA thread, barriers for __syncthreads and for each
    warp's ballots), equals the twin bit for bit with and without a
    framebuffer, the count included; raster_common.cuh's blend_over equals
    utils/color.blend_over on NaN, +-inf, alpha 0 and 1 and seeded values
    (skipped where there is no g++);
  * on the card (`gpu`): the merging entry against its twin at config 4,
    config 5, config 5 in 8 bands, the stress windows, with the count (python
    -m pytest --noconftest -m gpu tests/test_torch_merge_epilogue.py).
"""

import ctypes
import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.models import scenes as pscenes
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.ops import pipeline as ppipe
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.utils.color import blend_over

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H4, W4 = 48, 72  # config 4 small: ragged edge tiles on both axes
SHARD = (13, 21, 29, 43)  # (y0, x0, h, w) of config 4 small


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


def config4_args(device, window=None, width=W4, height=H4):
    """render_fused's positional arguments for config 4's one run of draws
    over `window` (y0, x0, h, w) of the frame (all of it when None)."""
    spec = pscenes.make_config4(width=width, height=height, device=device)
    sub = spec.submission(0.4)
    batch = ppipe.pack_draws(sub.draws, sub.view_proj, sub.light,
                             sub.sampling_mode, width, height,
                             near_clip=sub.near_clip)
    y0, x0, h, w = window or (0, 0, height, width)
    bins = pbin.bin_triangles(batch.coef, batch.bbox, batch.valid, h, w, y0,
                              x0, prf.TILE_H, prf.TILE_W)
    return (batch.coef, batch.payload, bins, batch.tex_lut, sub.light, h, w,
            y0, x0)


def config5_args(device):
    """render_fused's positional arguments for config 5 (1,000,000
    triangles at 3840x2160), and its scene."""
    spec = pscenes.make_config5(device=device)
    sub = spec.submission(0.5)
    batch = ppipe.pack_draws(sub.draws, sub.view_proj, sub.light,
                             sub.sampling_mode, spec.width, spec.height,
                             near_clip=sub.near_clip)
    bins = pbin.bin_triangles(batch.coef, batch.bbox, batch.valid,
                              spec.height, spec.width, 0, 0, prf.TILE_H,
                              prf.TILE_W)
    return (batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            spec.height, spec.width, 0, 0), spec


def stress_args(name, window, device):
    corners, h, w = stress.CASES[name]()
    setup = stress.setup(corners, h, w, device)
    payload, lut = stress.payload(corners, 5, device)
    y0, x0, bh, bw = window
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, bh, bw,
                              y0, x0, prf.TILE_H, prf.TILE_W)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    return (setup.coef, payload, bins, lut, light, bh, bw, y0, x0)


def edge_args(name, device):
    case = ec.CASES[name]()
    batch, bins, light = ec.pack(case, device)
    return (batch.coef, batch.payload, bins, batch.tex_lut, light,
            case.height, case.width, 0, 0)


ARGS = {
    "config4": lambda dev: config4_args(dev),
    "config4 shard": lambda dev: config4_args(dev, SHARD),
    "deep_tile shard": lambda dev: stress_args("deep_tile", (3, 5, 41, 70),
                                               dev),
    "nonfinite_uvs": lambda dev: edge_args("nonfinite_uvs", dev),
}


def seeded_fb(z, seed):
    """A framebuffer over which some covered pixels win and some lose: depth
    +inf (a covered pixel wins), z itself (a tie: it loses), uniform, or NaN
    (never wins); colour uniform with a few NaN channels."""
    rng = np.random.default_rng(seed)
    h, w = z.shape
    u = rng.uniform(0, 1, (h, w))
    depth = np.where(u < 0.4, np.inf, np.where(
        u < 0.6, z.cpu().numpy(), np.where(
            u < 0.95, rng.uniform(0, 1, (h, w)), np.nan))).astype(np.float32)
    color = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    color[rng.uniform(0, 1, (h, w, 4)) < 0.01] = np.nan
    return pfb.Framebuffer(torch.from_numpy(color).to(z.device),
                           torch.from_numpy(depth).to(z.device))


def torch_merge(fb, z, src):
    """The draw call's merge before it moved into K1: (Framebuffer, count)."""
    win = z < fb.depth
    return (pfb.Framebuffer(
        torch.where(win[..., None], blend_over(src, fb.color), fb.color),
        torch.where(win, z, fb.depth)), win.sum(dtype=torch.int32))


def assert_same_bits(tag, got, want):
    """Bit-equal; a NaN may be any NaN, at the same places."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, tag
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), tag
    g = torch.where(nan, 0, got.view(torch.int32))
    w = torch.where(nan, 0, want.view(torch.int32))
    assert torch.equal(g, w), f"{tag}: {int((g != w).sum())} elements differ"


def assert_same_fb(tag, got, want):
    assert_same_bits(f"{tag} colour", got.color, want.color)
    assert_same_bits(f"{tag} depth", got.depth, want.depth)


def fb_bits(fb):
    return [t.clone().view(torch.int32) for t in fb]


# ------------------------------------------------------- the twin's merge


@pytest.mark.parametrize("name", sorted(ARGS))
def test_the_twins_merge_is_the_torch_merge(name):
    args = ARGS[name](CPU)
    z, src, overflow = prf.render_fused_plain(*args)
    fb = seeded_fb(z, 7)
    want, count = torch_merge(fb, z, src)
    got, o, shaded = prf.render_fused_plain(*args, fb=fb, count_shaded=True)
    assert_same_fb(name, got, want)
    assert shaded.dtype == torch.int32 and int(shaded) == int(count)
    assert int(o) == int(overflow)
    # render_fused on the CPU: the twin, into `out`, uncounted, no launch
    launches = prf.KERNEL_LAUNCHES
    out = (torch.full_like(fb.color, 7.0), torch.full_like(fb.depth, 7.0))
    got, _, shaded = prf.render_fused(*args, fb=fb, out=out)
    assert got.color is out[0] and got.depth is out[1] and shaded is None
    assert_same_fb(f"{name} into out", got, want)
    assert prf.KERNEL_LAUNCHES == launches
    n_win, covered = int(count), int(torch.isfinite(z).sum())
    assert 0 < n_win < covered, (n_win, covered)


def test_merge_arguments_are_checked():
    args = config4_args(CPU)
    z, _, _ = prf.render_fused_plain(*args)
    fb = seeded_fb(z, 1)
    with pytest.raises(ValueError, match="framebuffer"):
        prf.render_fused(*args, count_shaded=True)
    with pytest.raises(ValueError, match="fb must be f32"):
        prf.render_fused(*args, fb=pfb.Framebuffer(fb.color[1:], fb.depth))
    with pytest.raises(ValueError, match="out must be f32"):
        prf.render_fused(*args, fb=fb, out=(fb.color.double(), fb.depth))


# ------------------------------------------------------ the banded frame


@pytest.mark.parametrize("opts", [dict(row_bands=4),
                                  dict(row_bands=4, band_shared=False)])
def test_banded_frame_equals_the_cat_of_its_bands(opts):
    """Each band's launch writes its rows of one pair of planes: the frame
    equals the `torch.cat` of the bands merged one by one, as the banded
    route made it before, and the counters are the bands' sum."""
    spec = pscenes.make_config4(width=W4, height=H4, device=CPU)
    sub = spec.submission(0.4)
    batch = ppipe.pack_draws(sub.draws, sub.view_proj, sub.light,
                             sub.sampling_mode, W4, H4,
                             near_clip=sub.near_clip)
    z, _, _ = prf.render_fused_plain(*config4_args(CPU))
    fb = seeded_fb(z, 3)
    bands = ppipe.band_opts(opts)
    got, counters = ppipe._render_banded(fb, batch, sub.light, 0, 0, H4,
                                         bands, True)
    band_h = H4 // bands.row_bands
    all_bins = pbin.bin_bands(batch.coef, batch.bbox, batch.valid, H4, W4,
                              bands.row_bands, 0, 0, prf.TILE_H, prf.TILE_W,
                              bands.shared, bands.distributed)
    parts, count = [], 0
    for b, bins in enumerate(all_bins):
        rows = slice(b * band_h, (b + 1) * band_h)
        zb, srcb, _ = prf.render_fused_plain(
            batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            band_h, W4, b * band_h, 0)
        part, n = torch_merge(pfb.Framebuffer(fb.color[rows], fb.depth[rows]),
                              zb, srcb)
        parts.append(part)
        count += int(n)
    want = pfb.Framebuffer(torch.cat([p.color for p in parts]),
                           torch.cat([p.depth for p in parts]))
    assert_same_fb("banded", got, want)
    assert int(counters.pixels_shaded) == count > 0
    whole, _ = torch_merge(fb, *prf.render_fused_plain(*config4_args(CPU))[:2])
    assert_same_fb("banded vs whole frame", got, whole)


# ------------------------------------------------ the caller's framebuffer


def test_the_callers_framebuffer_is_not_written():
    spec = pscenes.make_config4(width=W4, height=H4, device=CPU)
    sub = spec.submission(0.4)
    z, _, _ = prf.render_fused_plain(*config4_args(CPU))
    fb = seeded_fb(z, 9)
    before = fb_bits(fb)
    outs = [
        prf.render_fused(*config4_args(CPU), fb=fb, count_shaded=True)[0],
        ppipe.draw_meshes(fb, sub.view_proj, sub.draws, light=sub.light,
                          sampling_mode=sub.sampling_mode),
        ppipe.draw_meshes(fb, sub.view_proj, sub.draws, light=sub.light,
                          sampling_mode=sub.sampling_mode,
                          raster_opts=dict(row_bands=3)),
    ]
    d = sub.draws[0]
    outs.append(ppipe.draw_mesh(fb, d.mesh, d.model, sub.view_proj,
                                texture=d.texture, light=sub.light,
                                color=d.color, shading=d.shading,
                                sampling_mode=sub.sampling_mode,
                                backend="fused"))
    for a, b in zip(before, fb_bits(fb)):
        assert torch.equal(a, b)
    for out in outs:
        assert out.color.data_ptr() != fb.color.data_ptr()
        assert out.depth.data_ptr() != fb.depth.data_ptr()


# --------------------------------------------------- against the reference


def test_draws_through_the_merge_match_the_jax_reference():
    """Config 4 small through draw_meshes (one run) and through one
    draw_mesh a draw, both on "fused", against the reference's draw_mesh
    chain on its "ref" route (jitted once); an edge case through
    draw_meshes against the reference's frame of it (its own tests'
    route)."""
    import jax
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import fb as jfb
    from dtrenderer_tpu.ops import pipeline as jpipe
    from dtrenderer_tpu_torch import convert
    from test_torch_edge_cases import (
        JAX_ROUTE, LIGHT, _assert_bar, _jax_frame,
    )
    from test_torch_pipeline import _compare_to_reference, _config4_draws

    h, w = 32, 48
    proj, light, draws = _config4_draws(h, w, 0.6)
    clear = [0.03, 0.03, 0.06, 1.0]

    @jax.jit
    def reference(color, depth):
        fb = jfb.clear(jfb.Framebuffer(color, depth), jnp.asarray(clear))
        for m, mdl, kw in draws:
            fb = jpipe.draw_mesh(fb, m, mdl, proj, light=light,
                                 shading="phong", sampling_mode="bilinear",
                                 backend="ref", **kw)
        return fb

    ref = reference(*jfb.create(h, w))
    meshes, texs, specs = {}, {}, []
    for m, mdl, kw in draws:
        kw = dict(kw)
        if "texture" in kw:
            kw["texture"] = texs.setdefault(
                id(kw["texture"]), convert.texture(kw["texture"], CPU))
        specs.append(ppipe.DrawSpec(meshes.setdefault(id(m),
                                                      convert.mesh(m, CPU)),
                                    convert.matrix(mdl, CPU),
                                    shading="phong", **kw))
    plight, pproj = convert.light(light, CPU), convert.matrix(proj, CPU)
    fb0 = pfb.clear(pfb.create(h, w, CPU), clear)
    batch = ppipe.pack_draws(specs, pproj, plight, "bilinear", w, h)
    out = ppipe.draw_meshes(fb0, pproj, specs, light=plight,
                            sampling_mode="bilinear")
    seq = fb0
    for s in specs:
        seq = ppipe.draw_mesh(seq, s.mesh, s.model, pproj, texture=s.texture,
                              light=plight, color=s.color, shading=s.shading,
                              sampling_mode="bilinear", backend="fused")
    for got in (out, seq):
        covered = _compare_to_reference(ref.color, ref.depth, got.color,
                                        got.depth, batch)
        assert covered > 500

    name = "nan_vertices"
    case = ec.CASES[name]()
    ref_color, ref_depth, _ = _jax_frame(case, JAX_ROUTE[name])
    got = ec.render(case, "fused", CPU, LIGHT)
    _assert_bar(name, got.color.numpy(), got.depth.numpy(), ref_color,
                ref_depth)


# ------------------------------------------- the kernel source on the host

# What nvcc gives the kernel and g++ does not: CUDA's vector type, __ldg,
# the launch's indices (one OS thread per CUDA thread of a block, the blocks
# one after another), shared memory (static arrays), __syncthreads (one
# barrier for the block), a warp's ballot (a barrier for its 32 threads
# around a shared vote word), __ffs, __popc and atomicAdd.
HOST_SHIM = r"""
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
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
static dim3 blockIdx, gridDim;
static thread_local dim3 threadIdx;
static std::barrier<>* host_block;
static std::barrier<>* host_warp[8];
static unsigned host_votes[8];
inline void __syncthreads() { host_block->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  host_warp[w]->arrive_and_wait();  // the warp's last vote word is cleared
  if (p) __atomic_fetch_or(&host_votes[w], 1u << lane, __ATOMIC_SEQ_CST);
  host_warp[w]->arrive_and_wait();
  const unsigned v = __atomic_load_n(&host_votes[w], __ATOMIC_SEQ_CST);
  host_warp[w]->arrive_and_wait();
  if (lane == 0) __atomic_store_n(&host_votes[w], 0u, __ATOMIC_SEQ_CST);
  return v;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
extern "C" void host_render_fused(
    const float* coef, const float* payload, const int* tile_start,
    const int* tri_ids, const float* tex_lut, const float* scalars,
    float* z_out, float* src_out, const float* fb_color, const float* fb_depth,
    float* out_color, float* out_depth, int* shaded, int tex_len, int height,
    int width, int y_offset, int x_offset) {
  gridDim = {static_cast<unsigned>((width + kTileW - 1) / kTileW),
             static_cast<unsigned>((height + kTileH - 1) / kTileH), 1};
  for (int w = 0; w < kThreads / 32; ++w) host_warp[w] = new std::barrier<>(32);
  for (unsigned by = 0; by < gridDim.y; ++by)
    for (unsigned bx = 0; bx < gridDim.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::barrier<> block(kThreads);
      host_block = &block;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < kThreads; ++t)
        threads.emplace_back([=] {
          threadIdx = {t, 0, 0};
          render_fused_kernel(
              coef, payload, tile_start, tri_ids,
              reinterpret_cast<const float4*>(tex_lut), scalars, z_out,
              reinterpret_cast<float4*>(src_out),
              reinterpret_cast<const float4*>(fb_color), fb_depth,
              reinterpret_cast<float4*>(out_color), out_depth, shaded,
              tex_len, height, width, y_offset, x_offset);
        });
      for (auto& th : threads) th.join();
    }
  for (int w = 0; w < kThreads / 32; ++w) delete host_warp[w];
}

extern "C" void host_blend_over(const float* src, const float* dst,
                                float* out, int n) {
  for (int i = 0; i < n; ++i) {
    const float* s = src + 4 * i;
    const float* d = dst + 4 * i;
    const float4 r = dtr::blend_over(make_float4(s[0], s[1], s[2], s[3]),
                                     make_float4(d[0], d[1], d[2], d[3]));
    out[4 * i] = r.x;
    out[4 * i + 1] = r.y;
    out[4 * i + 2] = r.z;
    out[4 * i + 3] = r.w;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/render_fused.cu built for the host: raster_common.cuh inlined
    with HOST_SHIM in place of the CUDA runtime, HOST_LAUNCH in place of the
    launch, no FMA contraction and no fast math."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    csrc = os.path.join(REPO, "dtrenderer_tpu_torch", "csrc")
    with open(os.path.join(csrc, "raster_common.cuh")) as f:
        header = f.read().replace("#include <cuda_runtime.h>", HOST_SHIM)
    with open(os.path.join(csrc, "render_fused.cu")) as f:
        src = f.read()
    src = src.replace('#include "raster_common.cuh"', header)
    src = src[:src.index('extern "C" cudaError_t dtr_render_fused(')]
    out = tmp_path_factory.mktemp("render_fused_host")
    cpp, lib = out / "render_fused_host.cpp", out / "render_fused_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-pthread", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.host_render_fused.argtypes = [p] * 13 + [i] * 5
    dll.host_blend_over.argtypes = [p, p, p, i]
    return dll


def host_render_fused(dll, coef, payload, bins, tex_lut, light, height,
                      width, y_offset=0, x_offset=0, *, fb=None,
                      count_shaded=False):
    """render_fused over the host build (outputs first filled with 7.0, so
    that a pixel the kernel misses shows)."""
    ins = [t.contiguous() for t in (coef, payload, bins.tile_start,
                                    bins.tri_ids, tex_lut)]
    scalars = prf.light_scalars(light)
    n = len(ins[-1])
    if fb is None:
        z = torch.full((height, width), 7.0)
        src = torch.full((height, width, 4), 7.0)
        dll.host_render_fused(*(t.data_ptr() for t in ins),
                              scalars.data_ptr(), z.data_ptr(),
                              src.data_ptr(), None, None, None, None, None, n,
                              height, width, y_offset, x_offset)
        return z, src
    color, depth = (t.contiguous() for t in fb)
    out = pfb.Framebuffer(torch.full((height, width, 4), 7.0),
                          torch.full((height, width), 7.0))
    shaded = torch.zeros((), dtype=torch.int32) if count_shaded else None
    dll.host_render_fused(*(t.data_ptr() for t in ins), scalars.data_ptr(),
                          None, None, color.data_ptr(), depth.data_ptr(),
                          out.color.data_ptr(), out.depth.data_ptr(),
                          None if shaded is None else shaded.data_ptr(), n,
                          height, width, y_offset, x_offset)
    return out, shaded


@pytest.mark.parametrize("name", ["config4 shard", "deep_tile shard",
                                  "nonfinite_uvs"])
def test_the_kernel_source_on_the_host_equals_its_twin(host_lib, name):
    args = ARGS[name](CPU)
    z, src, _ = prf.render_fused_plain(*args)
    hz, hsrc = host_render_fused(host_lib, *args)
    assert_same_bits(f"{name} z", hz, z)
    assert_same_bits(f"{name} src", hsrc, src)
    fb = seeded_fb(z, 5)
    before = fb_bits(fb)
    want, _, count = prf.render_fused_plain(*args, fb=fb, count_shaded=True)
    got, shaded = host_render_fused(host_lib, *args, fb=fb,
                                    count_shaded=True)
    assert_same_fb(name, got, want)
    assert int(shaded) == int(count) > 0
    got, shaded = host_render_fused(host_lib, *args, fb=fb)
    assert_same_fb(f"{name} uncounted", got, want)
    assert shaded is None
    for a, b in zip(before, fb_bits(fb)):
        assert torch.equal(a, b)


def test_blend_on_the_host_is_blend_over(host_lib):
    """raster_common.cuh blend_over, the blend of K1's merge and of the
    deferred shading kernel, against utils/color.blend_over: NaN, +-inf,
    0, -0, a subnormal, alpha 0 and 1 and seeded values in every channel."""
    rng = np.random.default_rng(0)
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 1e-40,
                          0.5])
    n = 4096
    src = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    dst = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    for a in (src, dst):
        pick = rng.uniform(0, 1, a.shape) < 0.3
        a[pick] = rng.choice(special, int(pick.sum()))
    src[:64, 3], src[64:128, 3] = 0.0, 1.0  # alpha 0 and 1 over any dst
    src_t, dst_t = torch.from_numpy(src), torch.from_numpy(dst)
    out = torch.full((n, 4), 7.0)
    host_lib.host_blend_over(src_t.data_ptr(), dst_t.data_ptr(),
                             out.data_ptr(), n)
    assert_same_bits("blend_over", out, blend_over(src_t, dst_t))
    assert torch.isnan(out).any() and torch.isinf(out).any()


# --------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _card_vs_twin(tag, args, seed):
    """The merging entry on the card against its twin on the same inputs,
    counted, one launch; fb not written. Returns the winners."""
    z, _, _ = prf.render_fused_plain(*args)
    fb = seeded_fb(z, seed)
    before = fb_bits(fb)
    launches = prf.KERNEL_LAUNCHES
    got, _, shaded = prf.render_fused(*args, fb=fb, count_shaded=True)
    assert prf.KERNEL_LAUNCHES == launches + 1
    want, _, count = prf.render_fused_plain(*args, fb=fb, count_shaded=True)
    assert_same_fb(tag, got, want)
    assert int(shaded) == int(count)
    for a, b in zip(before, fb_bits(fb)):
        assert torch.equal(a, b)
    return int(count)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["config4 1080p", "config5 4k"])
def test_merging_entry_equals_its_twin_on_the_card(scene):
    dev = _card()
    args = (config4_args(dev, width=1920, height=1080)
            if scene == "config4 1080p" else config5_args(dev)[0])
    assert _card_vs_twin(scene, args, 2) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(stress.CASES))
def test_merging_entry_equals_its_twin_on_the_card_stress(name):
    dev = _card()
    _, h, w = stress.CASES[name]()
    for i, window in enumerate(stress.windows(h, w)):
        assert _card_vs_twin(f"{name} {window}",
                             stress_args(name, window, dev), i) > 0


@pytest.mark.gpu
def test_banded_frame_on_the_card_equals_the_twins():
    """Config 5 in 8 row bands through draw_mesh: eight merging launches
    into one pair of planes, against the same frame with the pipeline's
    render_fused swapped for its twin (as the bench's gate does)."""
    dev = _card()
    args, spec = config5_args(dev)
    sub = spec.submission(0.5)
    d = sub.draws[0]
    fb = seeded_fb(prf.render_fused_plain(*args)[0], 4)

    def frame():
        return ppipe.draw_mesh(fb, d.mesh, d.model, sub.view_proj,
                               texture=d.texture, light=sub.light,
                               color=d.color, shading=d.shading,
                               sampling_mode=sub.sampling_mode,
                               backend="fused", near_clip=sub.near_clip,
                               raster_opts=dict(row_bands=8),
                               return_counters=True)

    launches = prf.KERNEL_LAUNCHES
    got, counters = frame()
    assert prf.KERNEL_LAUNCHES == launches + 8
    with mock.patch.object(ppipe, "render_fused", prf.render_fused_plain):
        want, want_counters = frame()
    assert prf.KERNEL_LAUNCHES == launches + 8
    assert_same_fb("config 5 in 8 bands", got, want)
    assert int(counters.pixels_shaded) == int(want_counters.pixels_shaded)

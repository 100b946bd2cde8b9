// Fused raster + shade kernel for Hopper (sm_90a): one launch renders every
// opaque triangle of a batched draw into a depth plane and a premultiplied
// colour plane.
//
// Replaces the Pallas TPU kernel dtrenderer_tpu/ops/render_fused.py::_make_kernel
// (launched there by _render_from_bins / _render_from_flat_bins). It computes
// the same function, not the same blocks:
//
//   phase 1 (visibility): per pixel, the (min z, min id) winner over the
//     tile's binned triangles, with the FORMULAS.md edge functions, top-left
//     rule, barycentrics and screen-affine z. The winner's id and
//     barycentrics are kept.
//   phase 2 (shading), covered pixels only: fetch the winner's 34-channel
//     payload, interpolate perspective-correctly with one divide, sample the
//     texture LUT (nearest, or bilinear when flags bit 1 is set), modulate by
//     the interpolated rgba, and apply per-pixel Phong when flags bit 0 is set.
//
// Design. One block per 16x16 screen tile, one thread per pixel. The tile's
// CSR id list (ascending ids, ops/binning.py) is walked in chunks of 256
// triangles staged through shared memory: each thread loads one triangle's
// 16 setup floats as four 16-byte loads, then every thread reads each staged
// triangle with a broadcast shared-memory load. The winner state
// (z, id, b0, b1, b2) lives in registers; nothing crosses blocks.
//
// What bounds it on the card. Phase 1 is per-pixel edge evaluation times the
// bin depth: about 20 float ops per (pixel, binned triangle). Small tiles keep
// the bin depth low (a 16x16 tile holds far fewer triangles than the TPU's
// 32x128 tiles, which held up to 1,228 at 1M triangles in 4K), and the
// broadcast staging keeps the triangle data out of the per-pixel load path.
// Phase 2 is gathers: one payload row (136 bytes) per covered pixel from
// global memory and one 16-byte texel per tap from a texel-major [L, 4] LUT;
// neighbouring pixels mostly share a winner, so these hit in L1/L2.
//
// Op-order contract (FORMULAS.md): every expression is written in the
// reference's order and the file is built with --fmad=false, so no a*b + c is
// contracted into an FMA (that would move the exact E == 0 top-left decisions
// on shared edges and the z / interp / lerp / dot values). Divides and sqrtf
// are IEEE (no fast math, no rsqrtf, no __fdividef). Float-to-int conversions
// clamp in float first and then truncate, as the reference does.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one thread per tile pixel
constexpr int kChunk = kThreads;           // triangles staged per pass
constexpr int kSetup = 16;                 // coef channels (ops/geometry.py)
constexpr int kPayload = 34;               // full payload layout
constexpr int kCorner0 = 4;                // payload: texmeta 3, flags 1, ...
constexpr int kCornerStride = 10;          // q, u*q, v*q, rgba*q, n*q

__device__ __forceinline__ float lerp2(float p, float q, float t) {
  return p + (q - p) * t;
}

// Texel fetch: clamp in float, truncate, combine in int32, clamp the index.
__device__ __forceinline__ float4 tap(const float4* __restrict__ lut,
                                      int tex_len, float base, float tw,
                                      float th, float xf, float yf) {
  const int tx = static_cast<int>(fminf(fmaxf(xf, 0.0f), tw - 1.0f));
  const int ty = static_cast<int>(fminf(fmaxf(yf, 0.0f), th - 1.0f));
  int idx = static_cast<int>(base) + ty * static_cast<int>(tw) + tx;
  idx = min(max(idx, 0), tex_len - 1);
  return __ldg(lut + idx);
}

__global__ void __launch_bounds__(kThreads)
render_fused_kernel(const float* __restrict__ coef,
                    const float* __restrict__ payload,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tri_ids,
                    const float4* __restrict__ lut,
                    const float* __restrict__ scalars,
                    float* __restrict__ z_out, float4* __restrict__ src_out,
                    int tex_len, int height, int width, int y_offset,
                    int x_offset) {
  __shared__ float4 s_coef[kChunk][kSetup / 4];
  __shared__ int s_id[kChunk];

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * kTileW + static_cast<int>(threadIdx.x) % kTileW;
  const int y = blockIdx.y * kTileH + static_cast<int>(threadIdx.x) / kTileW;
  const float px = static_cast<float>(x + x_offset) + 0.5f;
  const float py = static_cast<float>(y + y_offset) + 0.5f;

  // ---------------------------- phase 1 ----------------------------------
  float bz = INFINITY;
  int bid = INT_MAX;
  float bb0 = 0.0f, bb1 = 0.0f, bb2 = 0.0f;
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = start; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (static_cast<int>(threadIdx.x) < n) {
      const int id = tri_ids[base + threadIdx.x];
      const float4* row =
          reinterpret_cast<const float4*>(coef + static_cast<size_t>(id) * kSetup);
#pragma unroll
      for (int q = 0; q < kSetup / 4; ++q) s_coef[threadIdx.x][q] = __ldg(row + q);
      s_id[threadIdx.x] = id;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 c0 = s_coef[k][0];  // A0 B0 C0 A1
      const float4 c1 = s_coef[k][1];  // B1 C1 A2 B2
      const float4 c2 = s_coef[k][2];  // C2 inv_area2 z0 z1
      const float4 c3 = s_coef[k][3];  // z2 tl0 tl1 tl2
      const float e0 = (c0.x * px + c0.y * py) + c0.z;
      const float e1 = (c0.w * px + c1.x * py) + c1.y;
      const float e2 = (c1.z * px + c1.w * py) + c2.x;
      const bool inside = (e0 > 0.0f || (e0 == 0.0f && c3.y > 0.0f)) &&
                          (e1 > 0.0f || (e1 == 0.0f && c3.z > 0.0f)) &&
                          (e2 > 0.0f || (e2 == 0.0f && c3.w > 0.0f));
      if (!inside) continue;
      const float b0 = e0 * c2.y;
      const float b1 = e1 * c2.y;
      const float b2 = e2 * c2.y;
      const float z = (b0 * c2.z + b1 * c2.w) + b2 * c3.x;
      const int id = s_id[k];
      if (z < bz || (z == bz && id < bid)) {  // (min z, min id), FORMULAS.md
        bz = z;
        bid = id;
        bb0 = b0;
        bb1 = b1;
        bb2 = b2;
      }
    }
  }
  if (x >= width || y >= height) return;
  const size_t pix = static_cast<size_t>(y) * width + x;
  z_out[pix] = bz;
  if (bz == INFINITY) {  // uncovered
    src_out[pix] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  // ---------------------------- phase 2 ----------------------------------
  const float* p = payload + static_cast<size_t>(bid) * kPayload;
  auto interp = [&](int off) {
    const float a0 = __ldg(p + kCorner0 + off);
    const float a1 = __ldg(p + kCorner0 + kCornerStride + off);
    const float a2 = __ldg(p + kCorner0 + 2 * kCornerStride + off);
    return (bb0 * a0 + bb1 * a1) + bb2 * a2;
  };
  const float qf = interp(0);
  const float inv_qf = 1.0f / (qf != 0.0f ? qf : 1.0f);
  const float u = interp(1) * inv_qf;
  const float v = interp(2) * inv_qf;
  const float r = interp(3) * inv_qf;
  const float g = interp(4) * inv_qf;
  const float bcol = interp(5) * inv_qf;
  const float a = interp(6) * inv_qf;
  const float tbase = __ldg(p + 0);
  const float tw = __ldg(p + 1);
  const float th = __ldg(p + 2);
  const float flags = __ldg(p + 3);

  float4 texel;
  if (flags >= 2.0f) {  // flags bit 1: bilinear
    const float fxs = u * tw - 0.5f;
    const float fys = (1.0f - v) * th - 0.5f;
    const float x0f = floorf(fxs);
    const float y0f = floorf(fys);
    const float ax = fxs - x0f;
    const float ay = fys - y0f;
    const float4 t00 = tap(lut, tex_len, tbase, tw, th, x0f, y0f);
    const float4 t10 = tap(lut, tex_len, tbase, tw, th, x0f + 1.0f, y0f);
    const float4 t01 = tap(lut, tex_len, tbase, tw, th, x0f, y0f + 1.0f);
    const float4 t11 = tap(lut, tex_len, tbase, tw, th, x0f + 1.0f, y0f + 1.0f);
    texel.x = lerp2(lerp2(t00.x, t10.x, ax), lerp2(t01.x, t11.x, ax), ay);
    texel.y = lerp2(lerp2(t00.y, t10.y, ax), lerp2(t01.y, t11.y, ax), ay);
    texel.z = lerp2(lerp2(t00.z, t10.z, ax), lerp2(t01.z, t11.z, ax), ay);
    texel.w = lerp2(lerp2(t00.w, t10.w, ax), lerp2(t01.w, t11.w, ax), ay);
  } else {
    texel = tap(lut, tex_len, tbase, tw, th, floorf(u * tw),
                floorf((1.0f - v) * th));
  }
  float4 src = make_float4(texel.x * r, texel.y * g, texel.z * bcol, texel.w * a);

  if (fmodf(flags, 2.0f) > 0.0f) {  // flags bit 0: per-pixel Phong
    const float nx = interp(7) * inv_qf;
    const float ny = interp(8) * inv_qf;
    const float nz = interp(9) * inv_qf;
    const float d = (nx * nx + ny * ny) + nz * nz;
    const float nlen = sqrtf(d > 0.0f ? d : 1.0f);
    const float nxh = nx / nlen, nyh = ny / nlen, nzh = nz / nlen;
    const float lx = __ldg(scalars + 0), ly = __ldg(scalars + 1);
    const float lz = __ldg(scalars + 2), ambient = __ldg(scalars + 3);
    const float llen = sqrtf((lx * lx + ly * ly) + lz * lz);
    const float lxh = lx / llen, lyh = ly / llen, lzh = lz / llen;
    const float ndl = fmaxf((nxh * lxh + nyh * lyh) + nzh * lzh, 0.0f);
    const float term = ambient + (1.0f - ambient) * ndl;
    src.x *= term;
    src.y *= term;
    src.z *= term;
  }
  src_out[pix] = src;
}

}  // namespace

// Plain C entry point (bound with ctypes by kernels/render_fused.py).
// Launches on `stream`, allocates nothing, and returns the launch status.
extern "C" cudaError_t dtr_render_fused(const float* coef, const float* payload,
                                        const int* tile_start, const int* tri_ids,
                                        const float* tex_lut, const float* scalars,
                                        float* z_out, float* src_out, int tex_len,
                                        int height, int width, int y_offset,
                                        int x_offset, void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  render_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, payload, tile_start, tri_ids,
      reinterpret_cast<const float4*>(tex_lut), scalars, z_out,
      reinterpret_cast<float4*>(src_out), tex_len, height, width, y_offset,
      x_offset);
  return cudaGetLastError();
}

extern "C" int dtr_render_fused_tile_h() { return kTileH; }
extern "C" int dtr_render_fused_tile_w() { return kTileW; }

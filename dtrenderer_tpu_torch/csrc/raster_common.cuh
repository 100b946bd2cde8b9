// Device code shared by the port's three raster kernels (render_fused.cu,
// raster_visibility.cu, render_ordered.cu), so that their coverage, depth
// and shading are one piece of code and stay bit-identical by construction.
//
// Op-order contract (FORMULAS.md): every expression is written in the
// reference's order and each including file is built with --fmad=false, so
// no a*b + c is contracted into an FMA (that would move the exact E == 0
// top-left decisions on shared edges and the z / interp / lerp / dot values).
// Divides and sqrtf are IEEE (no fast math, no rsqrtf, no __fdividef).
// Float-to-int conversions clamp in float first and then truncate, as the
// reference's kernel does.
//
// Layouts (keep in sync with ops/geometry.py and ops/render_fused.py):
//   setup row, f32 [16]: A0 B0 C0 A1 | B1 C1 A2 B2 | C2 inv_area2 z0 z1 |
//     z2 tl0 tl1 tl2 (read as four float4);
//   payload row, f32 [34]: tex_base tw th flags, then per corner
//     (q, u*q, v*q, r*q, g*q, b*q, a*q, nx*q, ny*q, nz*q);
//   texture LUT: texel-major float4 [L];
//   scalars, f32 [4]: light direction x y z, ambient.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace dtr {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one thread per tile pixel
constexpr int kSetup = 16;                 // coef channels
constexpr int kPayload = 34;               // full payload layout
constexpr int kCorner0 = 4;                // payload: texmeta 3, flags 1, ...
constexpr int kCornerStride = 10;          // q, u*q, v*q, rgba*q, n*q

// Calls visit(k, z, b0, b1, b2), in k order, for each staged setup row
// s_coef[k], k < n, whose edge functions cover pixel centre (px, py) under
// the top-left rule, with its barycentrics and screen-affine depth. Every
// thread reads each row with broadcast shared-memory loads.
//
// The coverage test stays in this loop body, written with && and ||: nvcc
// then branches once, after edge 0, and predicates the other two edges. The
// same test returned from a helper function compiled to a branch per term
// (K1 about 18% slower at config 5 on an H100), and written with & and | it
// evaluated all nine comparisons before its one branch (a few % slower).
template <typename Visit>
__device__ __forceinline__ void for_each_covering(
    const float4 (*s_coef)[kSetup / 4], int n, float px, float py,
    Visit&& visit) {
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
    visit(k, (b0 * c2.z + b1 * c2.w) + b2 * c3.x, b0, b1, b2);
  }
}

// The (min z, min id) winner over one tile's CSR id list [start, end),
// staged through shared memory in chunks of kThreads triangles: each thread
// loads one triangle's 16 setup floats as four 16-byte loads. All threads of
// the block must call it; it declares its own staging arrays.
__device__ __forceinline__ void walk_winner(
    const float* __restrict__ coef, const int* __restrict__ tri_ids,
    int start, int end, float px, float py, float& bz, int& bid, float& bb0,
    float& bb1, float& bb2) {
  __shared__ float4 s_coef[kThreads][kSetup / 4];
  __shared__ int s_id[kThreads];
  bz = INFINITY;
  bid = INT_MAX;
  bb0 = bb1 = bb2 = 0.0f;
  for (int base = start; base < end; base += kThreads) {
    const int n = min(kThreads, end - base);
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
    for_each_covering(s_coef, n, px, py,
                      [&](int k, float z, float b0, float b1, float b2) {
      const int id = s_id[k];
      if (z < bz || (z == bz && id < bid)) {  // (min z, min id), FORMULAS.md
        bz = z;
        bid = id;
        bb0 = b0;
        bb1 = b1;
        bb2 = b2;
      }
    });
  }
}

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

// Payload rows for shade(): a row in global memory is read through the
// read-only data cache, a row staged in shared memory directly.
struct GlobalRow {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(p + i); }
};
struct SharedRow {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return p[i]; }
};

// The shaded, premultiplied source colour of one fragment: perspective-
// correct interpolation of payload row p with one divide, the texture LUT
// sampled nearest (or bilinear when flags bit 1 is set), modulated by the
// interpolated rgba, and per-pixel Phong when flags bit 0 is set.
template <typename Row>
__device__ __forceinline__ float4 shade(const Row& p, float b0, float b1,
                                        float b2,
                                        const float4* __restrict__ lut,
                                        int tex_len,
                                        const float* __restrict__ scalars) {
  auto interp = [&](int off) {
    const float a0 = p[kCorner0 + off];
    const float a1 = p[kCorner0 + kCornerStride + off];
    const float a2 = p[kCorner0 + 2 * kCornerStride + off];
    return (b0 * a0 + b1 * a1) + b2 * a2;
  };
  const float qf = interp(0);
  const float inv_qf = 1.0f / (qf != 0.0f ? qf : 1.0f);
  const float u = interp(1) * inv_qf;
  const float v = interp(2) * inv_qf;
  const float r = interp(3) * inv_qf;
  const float g = interp(4) * inv_qf;
  const float bcol = interp(5) * inv_qf;
  const float a = interp(6) * inv_qf;
  const float tbase = p[0];
  const float tw = p[1];
  const float th = p[2];
  const float flags = p[3];

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
  return src;
}

}  // namespace dtr

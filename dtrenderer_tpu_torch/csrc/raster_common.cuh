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
//
// The visibility walk of K1 and K2 (walk_winner). One block per 16x16 tile,
// one thread per pixel, the tile's CSR id list staged through shared memory
// in chunks of 256 triangles. Walking every staged triangle in every thread
// was issue-bound (scheduler slots), not bound by arithmetic or bytes: about
// 25-30 issued ops per (pixel, binned triangle), most of them on triangles that
// cannot cover the pixel (at BASELINE config 5, 4K and 1M triangles, 3.16M
// pairs x 256 pixels = 809M tests, of which under half lie inside the
// triangle's bbox). The walk now has two stages:
//
//   coarse, one thread per staged triangle: the thread that loads triangle
//     k's setup row also computes an 8-bit mask of the tile's sub-blocks the
//     triangle can cover (subblock_mask) and stores the row split by use:
//     one float4 per edge (A, B, C, tl) and one for depth (inv_area2, z0,
//     z1, z2), so a miss reads three float4 and only a hit the fourth;
//   fine, per warp: a warp is one 8x4 pixel sub-block (not a 16x2 strip), so
//     one mask bit speaks for the whole warp. Each lane reads one mask, the
//     warp ballots its own bit and visits only the set bits, in ascending k
//     (id order within the tile), with the per-pixel test as before.
//
// Why the coarse reject is exact. For a sub-block and an edge, the kernel
// evaluates the SAME expression as the per-pixel test, (A*px + B*py) + C,
// at the pixel centre of the sub-block corner that maximises it: the right
// column if A >= 0 else the left, the bottom row if B >= 0 else the top.
// IEEE round-to-nearest is monotone, so without FMA each of fl(A*px),
// fl(B*py), fl(. + .) and fl(. + C) is monotone in px and in py, and the
// corner's value is >= the value at every pixel of the sub-block. The bit
// stays set iff the corner passes the pixel's own test,
// e > 0 || (e == 0 && tl > 0); so a cleared bit means that no pixel of the
// sub-block passes that edge, and the winners, z and barycentrics are those
// of the unmasked walk bit for bit. Non-finite values: px and py are never
// 0, so the two products are never NaN unless A or B is, and then every
// pixel's e is NaN and fails too. If a pixel passes, its e is not NaN; a NaN
// at the corner would need opposite infinities among (A*px, B*py, C), and by
// monotonicity the pixel's sum would then be -inf or NaN and fail. The keep
// condition is written positively, so a NaN only ever clears a bit that no
// pixel could pass. The triangle's bbox is not used: its one-pixel slack is
// not a proof under rounding, and the edges alone already clear 3/4 of the
// bits at config 5.
//
// What bounds the new walk (H100, config 5: 3.16M pairs, 0.265 of the
// sub-block bits survive). Staging alone takes 0.10 ms and the coarse stage
// 0.03 ms of K2's 0.48 ms; the rest is the fine stage, about 47 issue slots
// per surviving (warp, triangle) test, most of which now find a covered
// lane and so run the depth and winner update as well. Tried and not kept:
// 4x8 sub-blocks (slower at config 4), two hits per loop turn or a
// prefetched next hit (no faster), and 4x4 quads with a warp walking two
// triangles at once (fewer tests but divergent loops: 0.49 ms).
//
// ptxas (sm_90a, CUDA 12.9, -Xptxas -v): render_fused_kernel 32 registers,
// 68 bytes of spill stores and 76 of spill loads with its merge epilogue
// (44 and 52 without it); raster_visibility_kernel
// 32 registers, 16 and 24 bytes (both capped by kWalkBlocksPerSM; without
// the cap 48 registers each and no spills; the walk they replace: 38 and 32
// registers, no spills). render_ordered_kernel, untouched: 40, no spills.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace dtr {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one thread per tile pixel
// K1 and K2 ask ptxas for 8 resident blocks an SM (32 registers a thread, a
// few spilled words in the coarse stage): the walk waits on its staging
// loads and on its slowest warp, and more blocks in flight hide both (K2 at
// config 5 on an H100: 0.50 ms with 48 registers, 0.48 ms with 32).
constexpr int kWalkBlocksPerSM = 8;
constexpr int kSubH = 4;                   // a warp's pixel sub-block
constexpr int kSubW = 8;
constexpr int kSubCols = kTileW / kSubW;
constexpr int kSubRows = kTileH / kSubH;
constexpr int kSubs = kSubCols * kSubRows;  // sub-blocks (= warps) per tile
constexpr int kSetup = 16;                 // coef channels
constexpr int kPayload = 34;               // full payload layout
constexpr int kCorner0 = 4;                // payload: texmeta 3, flags 1, ...
constexpr int kCornerStride = 10;          // q, u*q, v*q, rgba*q, n*q

static_assert(kSubH * kSubW == 32 && kSubs * 32 == kThreads && kSubs <= 8,
              "one warp per sub-block, one mask bit per warp");

// Centre of pixel i (frame coordinates) on one axis.
__device__ __forceinline__ float pixel_centre(int i) {
  return static_cast<float>(i) + 0.5f;
}

// This thread's pixel within its block's tile, K1 and K2: warp w owns
// sub-block (w % kSubCols, w / kSubCols) and lane l its pixel
// (l % kSubW, l / kSubW), so a warp stores 32-byte (z, tri) and 128-byte
// (float4 colour) segments per sub-block row.
__device__ __forceinline__ void warp_pixel(int& lx, int& ly) {
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  lx = (warp % kSubCols) * kSubW + lane % kSubW;
  ly = (warp / kSubCols) * kSubH + lane / kSubW;
}

// Calls visit(k, z, b0, b1, b2), in k order, for each staged setup row
// s_coef[k], k < n, whose edge functions cover pixel centre (px, py) under
// the top-left rule, with its barycentrics and screen-affine depth. Every
// thread reads each row with broadcast shared-memory loads. K3's walk
// (pixels in 16x2 strips, no coarse stage).
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

// The coarse stage for one triangle and one tile: bit s of the result is
// set unless one of the edges (each A, B, C, tl) fails at the corner of
// sub-block s that maximises it, which proves that it fails at every pixel
// of the sub-block (header comment). (fx0, fy0) is the tile's first pixel
// in frame coordinates. Per edge: one product per sub-block column and per
// sub-block row, then the pixel test's own two sums per sub-block.
__device__ __forceinline__ unsigned subblock_mask(const float4 (&edge)[3],
                                                  int fx0, int fy0) {
  unsigned mask = (1u << kSubs) - 1u;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float A = edge[e].x, B = edge[e].y, C = edge[e].z, tl = edge[e].w;
    const int dx = A >= 0.0f ? kSubW - 1 : 0;
    const int dy = B >= 0.0f ? kSubH - 1 : 0;
    float ax[kSubCols], by[kSubRows];
#pragma unroll
    for (int c = 0; c < kSubCols; ++c)
      ax[c] = A * pixel_centre(fx0 + c * kSubW + dx);
#pragma unroll
    for (int r = 0; r < kSubRows; ++r)
      by[r] = B * pixel_centre(fy0 + r * kSubH + dy);
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      const float v = (ax[s % kSubCols] + by[s / kSubCols]) + C;
      if (!(v > 0.0f || (v == 0.0f && tl > 0.0f))) mask &= ~(1u << s);
    }
  }
  return mask;
}

// The (min z, min id) winner, with its barycentrics, of this thread's pixel
// (warp_pixel) over one tile's CSR id list [start, end), staged through
// shared memory in chunks of kThreads triangles. (fx0, fy0) is the tile's
// first pixel in frame coordinates. All threads of the block must call it;
// it declares its own staging arrays.
__device__ __forceinline__ void walk_winner(
    const float* __restrict__ coef, const int* __restrict__ tri_ids,
    int start, int end, int fx0, int fy0, float& bz, int& bid, float& bb0,
    float& bb1, float& bb2) {
  __shared__ float4 s_edge[kThreads][3];  // per edge: A B C tl
  __shared__ float4 s_depth[kThreads];    // inv_area2 z0 z1 z2
  __shared__ int s_id[kThreads];
  __shared__ unsigned char s_mask[kThreads];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const unsigned my_sub = 1u << (tid / 32);
  int lx, ly;
  warp_pixel(lx, ly);
  const float px = pixel_centre(fx0 + lx);
  const float py = pixel_centre(fy0 + ly);
  bz = INFINITY;
  bid = INT_MAX;
  bb0 = bb1 = bb2 = 0.0f;
  for (int base = start; base < end; base += kThreads) {
    const int n = min(kThreads, end - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (tid < n) {    // coarse stage: thread k stages triangle k
      const int id = tri_ids[base + tid];
      const float4* row =
          reinterpret_cast<const float4*>(coef + static_cast<size_t>(id) * kSetup);
      const float4 r0 = __ldg(row + 0);  // A0 B0 C0 A1
      const float4 r1 = __ldg(row + 1);  // B1 C1 A2 B2
      const float4 r2 = __ldg(row + 2);  // C2 inv_area2 z0 z1
      const float4 r3 = __ldg(row + 3);  // z2 tl0 tl1 tl2
      const float4 edge[3] = {make_float4(r0.x, r0.y, r0.z, r3.y),
                              make_float4(r0.w, r1.x, r1.y, r3.z),
                              make_float4(r1.z, r1.w, r2.x, r3.w)};
#pragma unroll
      for (int e = 0; e < 3; ++e) s_edge[tid][e] = edge[e];
      s_depth[tid] = make_float4(r2.y, r2.z, r2.w, r3.x);
      s_id[tid] = id;
      s_mask[tid] = static_cast<unsigned char>(subblock_mask(edge, fx0, fy0));
    }
    __syncthreads();
    // fine stage: 32 masks a step, this warp's bit balloted, hits in k order
    for (int k0 = 0; k0 < n; k0 += 32) {
      unsigned hits = __ballot_sync(
          0xffffffffu, k0 + lane < n && (s_mask[k0 + lane] & my_sub) != 0u);
      while (hits != 0u) {
        const int k = k0 + __ffs(static_cast<int>(hits)) - 1;
        hits &= hits - 1u;
        // coverage written with && and || in this loop body, as in
        // for_each_covering (one branch after edge 0)
        const float4 c0 = s_edge[k][0];
        const float4 c1 = s_edge[k][1];
        const float4 c2 = s_edge[k][2];
        const float e0 = (c0.x * px + c0.y * py) + c0.z;
        const float e1 = (c1.x * px + c1.y * py) + c1.z;
        const float e2 = (c2.x * px + c2.y * py) + c2.z;
        const bool inside = (e0 > 0.0f || (e0 == 0.0f && c0.w > 0.0f)) &&
                            (e1 > 0.0f || (e1 == 0.0f && c1.w > 0.0f)) &&
                            (e2 > 0.0f || (e2 == 0.0f && c2.w > 0.0f));
        if (!inside) continue;
        const float4 d = s_depth[k];
        const float b0 = e0 * d.x;
        const float b1 = e1 * d.x;
        const float b2 = e2 * d.x;
        const float z = (b0 * d.y + b1 * d.z) + b2 * d.w;
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

// Premultiplied source-over in utils/color.blend_over's op order,
// src + dst * (1 - src.a) per channel: the merge of K1's epilogue and of the
// deferred shading kernel.
__device__ __forceinline__ float4 blend_over(const float4& src,
                                             const float4& dst) {
  const float keep = 1.0f - src.w;
  return make_float4(src.x + dst.x * keep, src.y + dst.y * keep,
                     src.z + dst.z * keep, src.w + dst.w * keep);
}

}  // namespace dtr

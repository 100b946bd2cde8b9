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
// Design. One block per 16x16 screen tile, one thread per pixel, each of the
// 8 warps an 8x4 pixel sub-block. The tile's CSR id list (ascending ids,
// ops/binning.py) is walked in chunks of 256 triangles staged through shared
// memory (raster_common.cuh walk_winner): the thread that stages a triangle
// also computes which sub-blocks it can cover, and a warp runs the per-pixel
// edge test only for the triangles whose mask has its bit. The winner state
// (z, id, b0, b1, b2) lives in registers; nothing crosses blocks. Phase 1 and
// the shading are the shared device code of raster_common.cuh, which the
// visibility kernel (raster_visibility.cu) and the ordered kernel
// (render_ordered.cu) use too.
//
// What bounds it on the card. Phase 1 was issue-bound (scheduler slots) on
// rejected tests, not by arithmetic: every pixel ran the whole edge test
// (about 25-30 issued ops) for every triangle of its tile's bin, although
// most of a bin's triangles miss most of the tile. The coarse reject of
// raster_common.cuh (its header has the design, the exactness argument and
// the registers) leaves about a quarter of those tests at config 5; what
// remains is issue-bound on the surviving tests plus the latency of staging
// a tile's rows. Phase 2 is gathers: one payload row (136 bytes) per covered
// pixel from global memory and one 16-byte texel per tap from a texel-major
// [L, 4] LUT; neighbouring pixels mostly share a winner, so these hit in
// L1/L2.
//
// Op order: see raster_common.cuh (built with --fmad=false, IEEE divide and
// sqrt).

#include "raster_common.cuh"

using namespace dtr;

namespace {

__global__ void __launch_bounds__(kThreads, kWalkBlocksPerSM)
render_fused_kernel(const float* __restrict__ coef,
                    const float* __restrict__ payload,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tri_ids,
                    const float4* __restrict__ lut,
                    const float* __restrict__ scalars,
                    float* __restrict__ z_out, float4* __restrict__ src_out,
                    int tex_len, int height, int width, int y_offset,
                    int x_offset) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  int lx, ly;
  warp_pixel(lx, ly);
  const int x = tx0 + lx;
  const int y = ty0 + ly;

  // ---------------------------- phase 1 ----------------------------------
  float bz, bb0, bb1, bb2;
  int bid;
  walk_winner(coef, tri_ids, tile_start[tile], tile_start[tile + 1],
              tx0 + x_offset, ty0 + y_offset, bz, bid, bb0, bb1, bb2);
  if (x >= width || y >= height) return;
  const size_t pix = static_cast<size_t>(y) * width + x;
  z_out[pix] = bz;
  if (bz == INFINITY) {  // uncovered
    src_out[pix] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  // ---------------------------- phase 2 ----------------------------------
  src_out[pix] = shade(GlobalRow{payload + static_cast<size_t>(bid) * kPayload},
                       bb0, bb1, bb2, lut, tex_len, scalars);
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

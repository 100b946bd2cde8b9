// Visibility raster kernel for Hopper (sm_90a): the per-pixel (min z, min id)
// winner of every binned triangle, written as a depth plane and a triangle-id
// plane (the G-buffer that pipeline.shade_deferred shades).
//
// Replaces the Pallas TPU kernel dtrenderer_tpu/ops/raster_pallas.py::_make_kernel
// (launched there by _raster_from_bins). The TPU kernel walks dense bins in
// chunks of 8 triangles on the sublane axis, reduces each chunk to its
// (min z, min id) and merges that into a running best; that chunking is a
// vector-unit layout, and the per-triangle merge below gives the same winner.
//
// Design. K1's phase 1 without the barycentrics' use and without phase 2:
// one block per 16x16 screen tile, one thread per pixel, each of the 8 warps
// an 8x4 pixel sub-block, the tile's CSR id list (ascending ids,
// ops/binning.py) walked in chunks of 256 triangles staged through shared
// memory, the winner (z, id) in registers. The walk is raster_common.cuh
// walk_winner, the same code as render_fused.cu's, so the two kernels pick
// the same winner bit for bit. Ragged edge tiles are masked at the store.
// Uncovered pixels get z = +inf and id = -1.
//
// What bounds it on the card. Walking every staged triangle in every pixel
// was issue-bound (scheduler slots) on rejected tests, not by arithmetic:
// about 25-30 issued ops per (pixel, binned triangle), most of them for
// triangles that miss the pixel's neighbourhood. walk_winner now rejects per
// warp first: the thread that stages a triangle computes which 8x4
// sub-blocks it can cover, exactly (raster_common.cuh has the argument and
// the registers), and a warp tests only the triangles that keep its bit,
// about a quarter of them at config 5. The outputs are 8 bytes a pixel and
// the inputs 64 bytes a binned triangle, read once per tile; what remains is
// issue slots on the surviving tests and the latency of staging.
//
// Op order: see raster_common.cuh (built with --fmad=false).

#include "raster_common.cuh"

using namespace dtr;

namespace {

__global__ void __launch_bounds__(kThreads, kWalkBlocksPerSM)
raster_visibility_kernel(const float* __restrict__ coef,
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tri_ids,
                         float* __restrict__ z_out, int* __restrict__ tri_out,
                         int height, int width, int y_offset, int x_offset) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  int lx, ly;
  warp_pixel(lx, ly);
  const int x = tx0 + lx;
  const int y = ty0 + ly;

  float bz, bb0, bb1, bb2;
  int bid;
  walk_winner(coef, tri_ids, tile_start[tile], tile_start[tile + 1],
              tx0 + x_offset, ty0 + y_offset, bz, bid, bb0, bb1, bb2);
  if (x >= width || y >= height) return;
  const size_t pix = static_cast<size_t>(y) * width + x;
  z_out[pix] = bz;
  tri_out[pix] = bz == INFINITY ? -1 : bid;
}

}  // namespace

// Plain C entry point (bound with ctypes by kernels/raster_visibility.py).
// Launches on `stream`, allocates nothing, and returns the launch status.
extern "C" cudaError_t dtr_raster_visibility(const float* coef,
                                             const int* tile_start,
                                             const int* tri_ids, float* z_out,
                                             int* tri_out, int height, int width,
                                             int y_offset, int x_offset,
                                             void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  raster_visibility_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      coef, tile_start, tri_ids, z_out, tri_out, height, width, y_offset,
      x_offset);
  return cudaGetLastError();
}

extern "C" int dtr_raster_visibility_tile_h() { return kTileH; }
extern "C" int dtr_raster_visibility_tile_w() { return kTileW; }

// Fused raster + shade kernel for Hopper (sm_90a): one launch renders every
// opaque triangle of a batched draw into a depth plane and a premultiplied
// colour plane, or, given a framebuffer, merges them into it (the draw
// call's path).
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
//   merge (with a framebuffer): the depth test against it, winner z <
//     depth; a winner writes its z and its colour blended over the
//     framebuffer's (raster_common.cuh blend_over), a loser copies the
//     framebuffer's pixel, both into fresh output planes; optionally the
//     winners are counted. The JAX package leaves this merge to XLA, after
//     the kernel (dtrenderer_tpu/ops/pipeline.py); the port's twin is the
//     same torch.where over blend_over (ops/render_fused.py merge_plain).
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
// L1/L2. The merge adds 20 bytes read per pixel (colour and depth) to the
// 20 written, and saves the separate passes over the frame that the torch
// merge makes (the z and src planes written and read again, blend_over's
// temporaries).
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
                    const float4* __restrict__ fb_color,
                    const float* __restrict__ fb_depth,
                    float4* __restrict__ out_color,
                    float* __restrict__ out_depth, int* __restrict__ shaded,
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
  const bool in_frame = x < width && y < height;
  const size_t pix = static_cast<size_t>(y) * width + x;

  if (fb_depth == nullptr) {  // the (z, src) planes, no merge
    if (!in_frame) return;
    z_out[pix] = bz;
    if (bz == INFINITY) {  // uncovered
      src_out[pix] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      return;
    }
    // -------------------------- phase 2 ----------------------------------
    src_out[pix] = shade(GlobalRow{payload + static_cast<size_t>(bid) * kPayload},
                         bb0, bb1, bb2, lut, tex_len, scalars);
    return;
  }

  // ------------------- phase 2 and the depth merge -------------------------
  // A pixel wins when its fragment is nearer than the framebuffer's depth
  // (+inf, uncovered, and a NaN depth never win); a winner is shaded and
  // blended over the framebuffer's colour, a loser copies its pixel through.
  bool win = false;
  if (in_frame) {
    const float d = fb_depth[pix];
    const float4 dst = fb_color[pix];
    win = bz < d;
    if (win) {
      out_color[pix] = blend_over(
          shade(GlobalRow{payload + static_cast<size_t>(bid) * kPayload}, bb0,
                bb1, bb2, lut, tex_len, scalars),
          dst);
      out_depth[pix] = bz;
    } else {
      out_color[pix] = dst;
      out_depth[pix] = d;
    }
  }
  if (shaded == nullptr) return;
  // The winners, counted exactly: a ballot per warp, one shared add per
  // warp, one global add per block. Every thread of the block is still here
  // (a ragged edge tile's threads outside the frame vote false).
  __shared__ int s_shaded;
  if (threadIdx.x == 0) s_shaded = 0;
  __syncthreads();
  const unsigned votes = __ballot_sync(0xffffffffu, win);
  if (threadIdx.x % 32 == 0 && votes != 0u) atomicAdd(&s_shaded, __popc(votes));
  __syncthreads();
  if (threadIdx.x == 0 && s_shaded != 0) atomicAdd(shaded, s_shaded);
}

}  // namespace

// Plain C entry point (bound with ctypes by kernels/render_fused.py).
// Without a framebuffer (fb_depth null) it writes z_out (+inf where
// uncovered) and src_out (0 where uncovered); with one it writes the merged
// framebuffer into out_color / out_depth (fresh planes: fb_color and
// fb_depth are only read) and, when `shaded` is not null, adds the winning
// pixels to *shaded. Launches on `stream`, allocates nothing, and returns
// the launch status.
extern "C" cudaError_t dtr_render_fused(
    const float* coef, const float* payload, const int* tile_start,
    const int* tri_ids, const float* tex_lut, const float* scalars,
    float* z_out, float* src_out, const float* fb_color, const float* fb_depth,
    float* out_color, float* out_depth, int* shaded, int tex_len, int height,
    int width, int y_offset, int x_offset, void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  render_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, payload, tile_start, tri_ids,
      reinterpret_cast<const float4*>(tex_lut), scalars, z_out,
      reinterpret_cast<float4*>(src_out),
      reinterpret_cast<const float4*>(fb_color), fb_depth,
      reinterpret_cast<float4*>(out_color), out_depth, shaded, tex_len,
      height, width, y_offset, x_offset);
  return cudaGetLastError();
}

extern "C" int dtr_render_fused_tile_h() { return kTileH; }
extern "C" int dtr_render_fused_tile_w() { return kTileW; }

// Ordered (submission-order) raster + shade + blend kernel for Hopper
// (sm_90a): the translucency path. Every triangle that covers a pixel and
// passes the depth test against the pixel's RUNNING depth is shaded, blended
// source-over onto the running colour and writes its depth, in triangle-id
// (= submission) order: the reference renderer's forward loop.
//
// Replaces the Pallas TPU kernel
// dtrenderer_tpu/ops/raster_ordered.py::_make_ordered_kernel (launched there
// by _render_from_ordered_bins). The TPU kernel DMAs a channel-major window
// of each tile's triangles and evaluates one triangle per step over the whole
// [16, 128] tile, splatting channels with lane gathers; none of that layout
// work is needed here.
//
// Design. Submission order matters only per pixel, so one block per 16x16
// screen tile and one thread per pixel, each thread a sequential loop: no
// atomics and no ordering between threads. A thread loads its pixel's colour
// and depth, then walks the tile's CSR id list (ascending ids, ops/binning.py)
// in chunks of 128 triangles whose setup rows (16 floats) and payload rows
// (34 floats) are staged in shared memory (25.6 KB), every thread reading
// each staged triangle with broadcast loads. Per triangle: coverage, z, and
// when inside && z < depth the shading of raster_common.cuh (the same code as
// render_fused.cu's phase 2), then color = src + color * (1 - src.a) and
// depth = z. The kernel writes fresh output planes; ragged edge tiles are
// masked.
//
// What bounds it on the card: like K1's phase 1, edge evaluation over every
// (pixel, binned triangle), plus one full shading per depth-test pass instead
// of one per pixel. The inputs are read once per tile into shared memory and
// the outputs are 20 bytes a pixel, so deep bins of large overlapping
// triangles make it arithmetic-bound; the loop cannot stop early, because a
// later triangle may still pass the running depth.
//
// Op order: see raster_common.cuh (built with --fmad=false, IEEE divide and
// sqrt).

#include "raster_common.cuh"

using namespace dtr;

namespace {

constexpr int kOrderedChunk = 128;  // triangles staged per pass

__global__ void __launch_bounds__(kThreads)
render_ordered_kernel(const float* __restrict__ coef,
                      const float* __restrict__ payload,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tri_ids,
                      const float4* __restrict__ lut,
                      const float* __restrict__ scalars,
                      const float4* __restrict__ color_in,
                      const float* __restrict__ depth_in,
                      float4* __restrict__ color_out,
                      float* __restrict__ depth_out, int tex_len, int height,
                      int width, int y_offset, int x_offset) {
  __shared__ float4 s_coef[kOrderedChunk][kSetup / 4];
  __shared__ float s_pay[kOrderedChunk * kPayload];
  __shared__ int s_id[kOrderedChunk];

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * kTileW + static_cast<int>(threadIdx.x) % kTileW;
  const int y = blockIdx.y * kTileH + static_cast<int>(threadIdx.x) / kTileW;
  const float px = static_cast<float>(x + x_offset) + 0.5f;
  const float py = static_cast<float>(y + y_offset) + 0.5f;
  const bool in_frame = x < width && y < height;
  const size_t pix = in_frame ? static_cast<size_t>(y) * width + x : 0;

  float4 color = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float depth = -INFINITY;  // out-of-frame threads never pass the depth test
  if (in_frame) {
    color = color_in[pix];
    depth = depth_in[pix];
  }

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = start; base < end; base += kOrderedChunk) {
    const int n = min(kOrderedChunk, end - base);
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
    // payload rows: neighbouring threads read neighbouring floats of a row
    for (int i = threadIdx.x; i < n * kPayload; i += kThreads) {
      const int k = i / kPayload;
      s_pay[i] = __ldg(payload + static_cast<size_t>(s_id[k]) * kPayload +
                       (i - k * kPayload));
    }
    __syncthreads();
    for_each_covering(s_coef, n, px, py,
                      [&](int k, float z, float b0, float b1, float b2) {
      if (!(z < depth)) return;  // strict: a later triangle at equal z loses
      const float4 src = shade(SharedRow{s_pay + k * kPayload}, b0, b1, b2,
                               lut, tex_len, scalars);
      const float one_m_a = 1.0f - src.w;
      color = make_float4(src.x + color.x * one_m_a, src.y + color.y * one_m_a,
                          src.z + color.z * one_m_a, src.w + color.w * one_m_a);
      depth = z;
    });
  }
  if (!in_frame) return;
  color_out[pix] = color;
  depth_out[pix] = depth;
}

}  // namespace

// Plain C entry point (bound with ctypes by kernels/render_ordered.py).
// Launches on `stream`, allocates nothing, and returns the launch status.
extern "C" cudaError_t dtr_render_ordered(
    const float* coef, const float* payload, const int* tile_start,
    const int* tri_ids, const float* tex_lut, const float* scalars,
    const float* color_in, const float* depth_in, float* color_out,
    float* depth_out, int tex_len, int height, int width, int y_offset,
    int x_offset, void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  render_ordered_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, payload, tile_start, tri_ids,
      reinterpret_cast<const float4*>(tex_lut), scalars,
      reinterpret_cast<const float4*>(color_in), depth_in,
      reinterpret_cast<float4*>(color_out), depth_out, tex_len, height, width,
      y_offset, x_offset);
  return cudaGetLastError();
}

extern "C" int dtr_render_ordered_tile_h() { return kTileH; }
extern "C" int dtr_render_ordered_tile_w() { return kTileW; }

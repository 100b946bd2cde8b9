// Deferred shading kernel for Hopper (sm_90a): shades the winning fragments
// of a visibility G-buffer (z, tri) and merges them into a framebuffer, in
// one launch (DS).
//
// The JAX package leaves this pass to XLA (dtrenderer_tpu/ops/pipeline.py
// shade_deferred: one gather of every pixel's setup row and corner
// attributes, then element-wise shading and a select); no pl.pallas_call
// computes it. Its port in plain torch (ops/pipeline.py
// shade_deferred_plain, the twin of this kernel) gathers the winners with
// nonzero, a host synchronise of varying shape, materialises their rows and
// scatters the blend back.
//
// Design. One thread per pixel of the [height, width] shard, row-major, so
// a warp reads 32 neighbouring z, tri and depth words and 32 float4 colours
// and writes the same. A pixel wins when tri >= 0 && z < depth (a NaN z
// never wins); a loser copies its colour and depth through. A winner reads
// the first three float4 of its setup row (A, B, C of the three edges and
// inv_area2; the depth and tie-break channels are not needed), recomputes
// e_k = (A_k*px + B_k*py) + C_k and b_k = e_k * inv_area2 at its pixel
// centre, exactly as walk_winner and geometry.coverage_and_depth do, and
// shades with raster_common.cuh's shade(), K1's phase 2, through a row
// adapter: channels 0-3 are the draw's constants (texture base 0, width,
// height, flags), the rest read the triangle's q-premultiplied corner
// attributes [3, 10] in place, at row t * attrs_stride (30 for a [T, 3, 10]
// tensor of its own, 34 for the corner channels of a vertex pass's payload,
// read without a copy). The blend is raster_common.cuh's blend_over
// (src + dst * (1 - src_a), as K1's merge). The outputs are fresh planes:
// the framebuffer the caller passed is never written.
//
// What bounds it on the card: bytes. Per pixel 28 bytes in (z, tri, depth,
// colour) and 20 out; per winning triangle its 48 setup bytes and the
// attribute channels shade() reads, fetched once from memory when its
// neighbouring pixels hit in L1/L2, and the texels it taps. Nothing is
// staged in shared memory: there is no reuse inside a block that the caches
// do not already give.
//
// Op order: see raster_common.cuh (built with --fmad=false, IEEE divide and
// sqrt).

#include "raster_common.cuh"

using namespace dtr;

namespace {

constexpr int kBlock = 256;
constexpr int kAttrs = 10;  // q, u*q, v*q, rgba*q, n*q per corner

static_assert(kCornerStride == kAttrs,
              "shade()'s corner channels index the attrs rows in place");

// shade()'s payload row for one deferred fragment: channels 0-3 the draw's
// constants, channel kCorner0 + c*kCornerStride + k = attrs[t, c, k].
// shade() indexes with constants, so the branch folds away.
struct DeferredRow {
  const float* attrs;  // the row of attrs[t], [3, kAttrs] contiguous
  float4 head;         // tex_base, tw, th, flags
  __device__ __forceinline__ float operator[](int i) const {
    if (i < kCorner0) {
      return i == 0 ? head.x : i == 1 ? head.y : i == 2 ? head.z : head.w;
    }
    return __ldg(attrs + (i - kCorner0));
  }
};

__global__ void __launch_bounds__(kBlock)
shade_deferred_kernel(const float* __restrict__ z,
                      const int* __restrict__ tri,
                      const float* __restrict__ depth,
                      const float4* __restrict__ color,
                      const float* __restrict__ coef,
                      const float* __restrict__ attrs,
                      const float4* __restrict__ lut,
                      const float* __restrict__ scalars,
                      float4* __restrict__ out_color,
                      float* __restrict__ out_depth, float4 head,
                      int tex_len, int attrs_stride, int height, int width,
                      int y_offset, int x_offset) {
  const size_t pix = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (pix >= static_cast<size_t>(height) * width) return;
  const float zp = z[pix];
  const int t = tri[pix];
  const float d = depth[pix];
  const float4 dst = color[pix];
  if (!(t >= 0 && zp < d)) {  // loses: the framebuffer's pixel as it was
    out_color[pix] = dst;
    out_depth[pix] = d;
    return;
  }
  const int y = static_cast<int>(pix / width);
  const int x = static_cast<int>(pix % width);
  const float px = pixel_centre(x + x_offset);
  const float py = pixel_centre(y + y_offset);
  const float4* row =
      reinterpret_cast<const float4*>(coef + static_cast<size_t>(t) * kSetup);
  const float4 c0 = __ldg(row + 0);  // A0 B0 C0 A1
  const float4 c1 = __ldg(row + 1);  // B1 C1 A2 B2
  const float4 c2 = __ldg(row + 2);  // C2 inv_area2 z0 z1
  const float e0 = (c0.x * px + c0.y * py) + c0.z;
  const float e1 = (c0.w * px + c1.x * py) + c1.y;
  const float e2 = (c1.z * px + c1.w * py) + c2.x;
  const float b0 = e0 * c2.y;
  const float b1 = e1 * c2.y;
  const float b2 = e2 * c2.y;
  const float4 src = shade(
      DeferredRow{attrs + static_cast<size_t>(t) * attrs_stride, head}, b0,
      b1, b2, lut, tex_len, scalars);
  out_color[pix] = blend_over(src, dst);
  out_depth[pix] = zp;
}

}  // namespace

// Plain C entry point (bound with ctypes by kernels/shade_deferred.py).
// tex_lut is the draw's texture as texel-major float4 [tw * th]; scalars
// the light (render_fused.light_scalars); flags as the payload's (bit 0
// Phong, bit 1 bilinear); attrs_stride the floats from one triangle's
// attribute row to the next (>= 3 * 10; a row's 30 channels contiguous).
// Launches on `stream`, allocates nothing, and returns the launch status.
extern "C" cudaError_t dtr_shade_deferred(
    const float* z, const int* tri, const float* depth, const float* color,
    const float* coef, const float* attrs, const float* tex_lut,
    const float* scalars, float* out_color, float* out_depth, float tw,
    float th, float flags, int tex_len, int attrs_stride, int height,
    int width, int y_offset, int x_offset, void* stream) {
  const size_t n = static_cast<size_t>(height) * width;
  if (height <= 0 || width <= 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  shade_deferred_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      z, tri, depth, reinterpret_cast<const float4*>(color), coef, attrs,
      reinterpret_cast<const float4*>(tex_lut), scalars,
      reinterpret_cast<float4*>(out_color), out_depth,
      make_float4(0.0f, tw, th, flags), tex_len, attrs_stride, height, width,
      y_offset, x_offset);
  return cudaGetLastError();
}

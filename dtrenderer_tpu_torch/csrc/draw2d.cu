// The 2D verbs for Hopper (sm_90a), D2: one launch per verb (rectangle,
// transformed rectangle, line, filled circle, circle outline, bitmap blit,
// a string of text) and the visibility G-buffer of api.render_triangle's one
// triangle.
//
// The JAX package leaves these to XLA (dtrenderer_tpu/ops/draw2d.py,
// dtrenderer_tpu/ops/text.py, dtrenderer_tpu/api.py render_triangle: a
// full-frame masked pass per verb; no pl.pallas_call computes them). Their
// port in plain torch (ops/draw2d.py draw_plain and triangle_gbuffer_plain,
// ops/text.py coverage_plain: the twins of this kernel) runs each verb over
// its window, a box the host works out from the verb's own values, in some
// 20-100 eager ATen operations a verb.
//
// Design. One thread per pixel of the frame (the output is a fresh colour
// plane, so every pixel is written, outside the window as a copy of the
// input), row-major, so a warp reads and writes 32 neighbouring
// float4 colours. A pixel inside the verb's window evaluates the verb's own
// pixel test, in the twin's op order, and blends its source colour over the
// framebuffer's with raster_common.cuh's blend_over (src + dst * (1 -
// src.a)); every other pixel copies its colour through. The verb's
// constants travel by value in the launch's parameters (a string: up to
// kMaxGlyphs glyphs' atlas cells and advance bounds; the wrapper splits a
// longer one into launches): no host-to-device copy, no host read. The
// triangle's entry writes z and tri over the frame (+inf and -1 outside the
// window) and, from its first thread, the setup row and corner attributes
// that the deferred shading kernel (DS) reads next.
//
// What bounds it on the card: bytes. A verb reads and writes the colour
// plane once, 32 bytes a pixel (66.4 MB at 1920x1080, 0.0198 ms at 3.35
// TB/s); the window's arithmetic is a few dozen operations on a few thousand
// pixels, and a bitmap's or the atlas's texels sit in L1/L2.
//
// Op order: FORMULAS.md and the twins (built with --fmad=false, IEEE divide
// and sqrt). Integer arithmetic wraps as torch's int32 tensors do, and
// float-to-int conversions of the blit follow math3d.to_i32 (XLA's).

#include "raster_common.cuh"

using namespace dtr;

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGlyphs = 256;  // glyphs of a string a launch takes
// ops/draw2d.py's verb kinds
constexpr int kRect = 0, kRectT = 1, kLine = 2, kCircle = 3, kRing = 4;

// Rows [y0, y1) and columns [x0, x1) of the frame.
struct Region {
  int y0, y1, x0, x1;
};

// A shape's colour and constants, in ops/draw2d.py Verb.params' layout.
struct Shape {
  int kind;
  float p[15];
};

struct Blit {
  float p[15];  // tint, cos sin, sx sy, px py, ox oy, w h, bilinear
  int bh, bw;
};

struct Text {
  float4 color;
  int x0, y0, scale, cw, ch, n, aw, ah, proportional;
  int ox[kMaxGlyphs];  // glyph i's atlas cell: column and row of its corner
  int oy[kMaxGlyphs];
  float bound[kMaxGlyphs + 1];  // proportional: cumulative advances
};

struct Triangle {
  float coef[16];   // the setup row (ops/geometry.py layout)
  float attrs[30];  // per corner q, u*q, v*q, rgba*q, n*q
};

// int32 arithmetic as torch's: two's complement wrap-around.
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
// a // b for b != 0 (floor), as torch's int floor division.
__device__ __forceinline__ int floor_div(int a, int b) {
  if (b == -1) return wsub(0, a);
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// utils/math3d.to_i32: truncate toward zero, NaN -> 0, saturate.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x < -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}

// The pixel centre (px, py) in the primitive's local box, as ops/draw2d.py
// _local: t = cos sin, sx sy, px py, ox oy, w h. True when inside [0, w) x
// [0, h).
__device__ __forceinline__ bool local_inside(const float* t, float px,
                                             float py, float& lx, float& ly) {
  const float dx = px - t[4];
  const float dy = py - t[5];
  const float rx = t[0] * dx - t[1] * dy;
  const float ry = t[1] * dx + t[0] * dy;
  lx = __fdiv_rn(rx, t[2]) + t[6];
  ly = __fdiv_rn(ry, t[3]) + t[7];
  return lx >= 0.0f && lx < t[8] && ly >= 0.0f && ly < t[9];
}

__device__ __forceinline__ bool shape_covers(const Shape& s, int x, int y,
                                             float4& src) {
  const float* p = s.p;
  src = make_float4(p[0], p[1], p[2], p[3]);
  const float px = pixel_centre(x);
  const float py = pixel_centre(y);
  switch (s.kind) {
    case kRect:
      return px >= p[4] && px < p[6] && py >= p[5] && py < p[7];
    case kRectT: {
      float lx, ly;
      return local_inside(p + 4, px, py, lx, ly);
    }
    case kLine: {  // integer coordinates, not centres
      const bool y_major = p[9] != 0.0f;
      const float maj = static_cast<float>(y_major ? y : x);
      const float mnr = static_cast<float>(y_major ? x : y);
      const float expect = floorf((p[5] + (maj - p[4]) * p[6]) + 0.5f);
      return mnr == expect && maj >= p[7] && maj <= p[8];
    }
    case kCircle: {
      const float ddx = px - p[4];
      const float ddy = py - p[5];
      return ddx * ddx + ddy * ddy <= p[6];
    }
    default: {  // kRing
      const float ddx = px - p[4];
      const float ddy = py - p[5];
      const float d = __fsqrt_rn(ddx * ddx + ddy * ddy);
      return fabsf(d - p[6]) <= p[7];
    }
  }
}

// ops/sampling.py on a bitmap [bh, bw] of float4, clamp-to-edge.
__device__ __forceinline__ float4 texel(const float4* __restrict__ image,
                                        int bw, int tx, int ty) {
  return __ldg(image + static_cast<size_t>(ty) * bw + tx);
}

__device__ __forceinline__ bool blit_covers(const Blit& b,
                                            const float4* __restrict__ image,
                                            int x, int y, float4& src) {
  const float* p = b.p;
  float lx, ly;
  if (!local_inside(p + 4, pixel_centre(x), pixel_centre(y), lx, ly))
    return false;
  const float u = __fdiv_rn(lx, p[12]);
  const float v = 1.0f - __fdiv_rn(ly, p[13]);
  const float tw = static_cast<float>(b.bw);
  const float th = static_cast<float>(b.bh);
  float4 t;
  if (p[14] != 0.0f) {  // bilinear
    const float fx = u * tw - 0.5f;
    const float fy = (1.0f - v) * th - 0.5f;
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float ax = fx - x0f;
    const float ay = fy - y0f;
    const int x0i = to_i32(x0f);
    const int y0i = to_i32(y0f);
    const int x0 = clampi(x0i, 0, b.bw - 1);
    const int x1 = clampi(wadd(x0i, 1), 0, b.bw - 1);
    const int y0 = clampi(y0i, 0, b.bh - 1);
    const int y1 = clampi(wadd(y0i, 1), 0, b.bh - 1);
    const float4 t00 = texel(image, b.bw, x0, y0);
    const float4 t10 = texel(image, b.bw, x1, y0);
    const float4 t01 = texel(image, b.bw, x0, y1);
    const float4 t11 = texel(image, b.bw, x1, y1);
    t.x = lerp2(lerp2(t00.x, t10.x, ax), lerp2(t01.x, t11.x, ax), ay);
    t.y = lerp2(lerp2(t00.y, t10.y, ax), lerp2(t01.y, t11.y, ax), ay);
    t.z = lerp2(lerp2(t00.z, t10.z, ax), lerp2(t01.z, t11.z, ax), ay);
    t.w = lerp2(lerp2(t00.w, t10.w, ax), lerp2(t01.w, t11.w, ax), ay);
  } else {
    const int tx = clampi(to_i32(floorf(u * tw)), 0, b.bw - 1);
    const int ty = clampi(to_i32(floorf((1.0f - v) * th)), 0, b.bh - 1);
    t = texel(image, b.bw, tx, ty);
  }
  src = make_float4(t.x * p[0], t.y * p[1], t.z * p[2], t.w * p[3]);
  return true;
}

// ops/text.py coverage_plain at one pixel: the glyph column, the pixel's
// place in its cell and the atlas's coverage there.
__device__ __forceinline__ bool text_covers(const Text& t,
                                            const float* __restrict__ atlas,
                                            int x, int y, float4& src) {
  const int ix = wsub(x, t.x0);
  const int iy = wsub(y, t.y0);
  const int ly = floor_div(iy, t.scale);
  if (!(ly >= 0 && ly < t.ch)) return false;
  int col, gx;
  if (!t.proportional) {
    const int lx = floor_div(ix, t.scale);
    col = floor_div(lx, t.cw);
    if (!(lx >= 0 && col < t.n)) return false;
    gx = wsub(lx, wmul(col, t.cw));
  } else {
    const float lx = __fdiv_rn(static_cast<float>(ix),
                               static_cast<float>(t.scale));
    if (!(lx >= t.bound[0] && lx < t.bound[t.n])) return false;
    int lo = 0, hi = t.n + 1;  // searchsorted(bounds, lx, right=True)
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (t.bound[mid] <= lx) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    col = clampi(lo - 1, 0, t.n - 1);
    const float d = lx - t.bound[col];  // in [0, advance): a plain cast
    gx = static_cast<int>(d);
    if (!(gx >= 0 && gx < t.cw)) return false;
  }
  const int ax = clampi(wadd(t.ox[col], gx), 0, t.aw - 1);
  const int ay = clampi(wadd(t.oy[col], ly), 0, t.ah - 1);
  const float cov = __ldg(atlas + static_cast<size_t>(ay) * t.aw + ax);
  src = make_float4(t.color.x * cov, t.color.y * cov, t.color.z * cov,
                    t.color.w * cov);
  return true;
}

// This thread's pixel of the [height, width] frame (false past its end)
// and its index.
__device__ __forceinline__ bool frame_pixel(int height, int width, int& x,
                                            int& y, size_t& pix) {
  pix = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (pix >= static_cast<size_t>(height) * width) return false;
  y = static_cast<int>(pix / width);
  x = static_cast<int>(pix % width);
  return true;
}

__device__ __forceinline__ bool in_window(const Region& w, int x, int y) {
  return y >= w.y0 && y < w.y1 && x >= w.x0 && x < w.x1;
}

__global__ void __launch_bounds__(kBlock)
shape_kernel(const __grid_constant__ Shape s, const float4* __restrict__ in,
             float4* __restrict__ out, Region win, int height, int width) {
  int x, y;
  size_t pix;
  if (!frame_pixel(height, width, x, y, pix)) return;
  const float4 dst = in[pix];
  float4 src;
  out[pix] = in_window(win, x, y) && shape_covers(s, x, y, src)
                 ? blend_over(src, dst)
                 : dst;
}

__global__ void __launch_bounds__(kBlock)
blit_kernel(const __grid_constant__ Blit b, const float4* __restrict__ image,
            const float4* __restrict__ in, float4* __restrict__ out,
            Region win, int height, int width) {
  int x, y;
  size_t pix;
  if (!frame_pixel(height, width, x, y, pix)) return;
  const float4 dst = in[pix];
  float4 src;
  out[pix] = in_window(win, x, y) && blit_covers(b, image, x, y, src)
                 ? blend_over(src, dst)
                 : dst;
}

__global__ void __launch_bounds__(kBlock)
text_kernel(const __grid_constant__ Text t, const float* __restrict__ atlas,
            const float4* in, float4* out, Region win, int height,
            int width) {
  // in and out are one buffer for a long string's later runs (each thread
  // reads its own pixel before it writes it), so neither is __restrict__.
  int x, y;
  size_t pix;
  if (!frame_pixel(height, width, x, y, pix)) return;
  const float4 dst = in[pix];
  float4 src;
  out[pix] = in_window(win, x, y) && text_covers(t, atlas, x, y, src)
                 ? blend_over(src, dst)
                 : dst;
}

// raster_ref.rasterize_ref of one valid triangle at one pixel: covered
// under the top-left rule and z < +inf, then (z, 0), else (+inf, -1).
__global__ void __launch_bounds__(kBlock)
triangle_kernel(const __grid_constant__ Triangle t, float* __restrict__ z,
                int* __restrict__ tri, float* __restrict__ coef_out,
                float* __restrict__ attrs_out, Region win, int height,
                int width) {
  int x, y;
  size_t pix;
  if (!frame_pixel(height, width, x, y, pix)) return;
  if (pix == 0) {  // the rows DS reads
    for (int k = 0; k < 16; ++k) coef_out[k] = t.coef[k];
    for (int k = 0; k < 30; ++k) attrs_out[k] = t.attrs[k];
  }
  float zv = INFINITY;
  int id = -1;
  if (in_window(win, x, y)) {
    const float* c = t.coef;
    const float px = pixel_centre(x);
    const float py = pixel_centre(y);
    const float e0 = (c[0] * px + c[1] * py) + c[2];
    const float e1 = (c[3] * px + c[4] * py) + c[5];
    const float e2 = (c[6] * px + c[7] * py) + c[8];
    const bool inside = (e0 > 0.0f || (e0 == 0.0f && c[13] > 0.0f)) &&
                        (e1 > 0.0f || (e1 == 0.0f && c[14] > 0.0f)) &&
                        (e2 > 0.0f || (e2 == 0.0f && c[15] > 0.0f));
    if (inside) {
      const float b0 = e0 * c[9];
      const float b1 = e1 * c[9];
      const float b2 = e2 * c[9];
      const float zz = (b0 * c[10] + b1 * c[11]) + b2 * c[12];
      if (zz < INFINITY) {
        zv = zz;
        id = 0;
      }
    }
  }
  z[pix] = zv;
  tri[pix] = id;
}

Region region(const int* r) { return Region{r[0], r[1], r[2], r[3]}; }

unsigned blocks_of(int height, int width) {
  const size_t n = static_cast<size_t>(height) * width;
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

Shape make_shape(int kind, const float* p) {
  Shape s;
  s.kind = kind;
  for (int k = 0; k < 15; ++k) s.p[k] = p[k];
  return s;
}

Blit make_blit(const float* p, int bh, int bw) {
  Blit b;
  for (int k = 0; k < 15; ++k) b.p[k] = p[k];
  b.bh = bh;
  b.bw = bw;
  return b;
}

// ints: x0 y0 scale cw ch n aw ah proportional; bounds: n + 1 values (read
// only when proportional).
Text make_text(const float* color, const int* ints, const int* ox,
               const int* oy, const float* bounds) {
  Text t;
  t.color = make_float4(color[0], color[1], color[2], color[3]);
  t.x0 = ints[0];
  t.y0 = ints[1];
  t.scale = ints[2];
  t.cw = ints[3];
  t.ch = ints[4];
  t.n = ints[5];
  t.aw = ints[6];
  t.ah = ints[7];
  t.proportional = ints[8];
  for (int k = 0; k < t.n; ++k) {
    t.ox[k] = ox[k];
    t.oy[k] = oy[k];
  }
  for (int k = 0; k <= kMaxGlyphs; ++k)
    t.bound[k] = t.proportional && k <= t.n ? bounds[k] : 0.0f;
  return t;
}

Triangle make_triangle(const float* coef, const float* attrs) {
  Triangle t;
  for (int k = 0; k < 16; ++k) t.coef[k] = coef[k];
  for (int k = 0; k < 30; ++k) t.attrs[k] = attrs[k];
  return t;
}

}  // namespace

// Plain C entry points (bound with ctypes by kernels/draw2d.py). `in` and
// `out` are f32 [height, width, 4] colour planes (16-byte aligned), win the
// verb's window (y0, y1, x0, x1); every pixel of `out` is written, outside
// the window as a copy of `in` (one pass over the frame: faster on an H100
// than a copy followed by a launch over the window alone, PERF.md). Each
// launches on `stream`, allocates nothing, and returns the launch status.
extern "C" cudaError_t dtr_draw2d_shape(int kind, const float* p,
                                        const float* in, float* out,
                                        int height, int width, const int* win,
                                        void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  shape_kernel<<<blocks_of(height, width), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      make_shape(kind, p), reinterpret_cast<const float4*>(in),
      reinterpret_cast<float4*>(out), region(win), height, width);
  return cudaGetLastError();
}

// image: the bitmap, f32 [bh, bw, 4] contiguous.
extern "C" cudaError_t dtr_draw2d_blit(const float* p, const float* image,
                                       int bh, int bw, const float* in,
                                       float* out, int height, int width,
                                       const int* win, void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  blit_kernel<<<blocks_of(height, width), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      make_blit(p, bh, bw), reinterpret_cast<const float4*>(image),
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      region(win), height, width);
  return cudaGetLastError();
}

// atlas: f32 [ah, aw] contiguous; at most kMaxGlyphs glyphs (n = ints[5]).
extern "C" cudaError_t dtr_draw2d_text(const float* color, const int* ints,
                                       const int* ox, const int* oy,
                                       const float* bounds,
                                       const float* atlas, const float* in,
                                       float* out, int height, int width,
                                       const int* win, void* stream) {
  if (ints[5] < 1 || ints[5] > kMaxGlyphs) return cudaErrorInvalidValue;
  if (height <= 0 || width <= 0) return cudaSuccess;
  text_kernel<<<blocks_of(height, width), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      make_text(color, ints, ox, oy, bounds), atlas,
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      region(win), height, width);
  return cudaGetLastError();
}

// z f32 and tri i32 [height, width], written everywhere; coef_out [16] and
// attrs_out [30] from the first pixel's thread.
extern "C" cudaError_t dtr_draw2d_triangle(const float* coef,
                                           const float* attrs, float* z,
                                           int* tri, float* coef_out,
                                           float* attrs_out, int height,
                                           int width, const int* win,
                                           void* stream) {
  if (height <= 0 || width <= 0) return cudaSuccess;
  triangle_kernel<<<blocks_of(height, width), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      make_triangle(coef, attrs), z, tri, coef_out, attrs_out, region(win),
      height, width);
  return cudaGetLastError();
}

extern "C" int dtr_draw2d_max_glyphs() { return kMaxGlyphs; }

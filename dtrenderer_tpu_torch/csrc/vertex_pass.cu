// The vertex stage and packing of a run of draws, one thread per source
// triangle, for Hopper (sm_90a).
//
// Replaces the vertex stage that the JAX package leaves to XLA, fused there
// into a few HLO fusions: dtrenderer_tpu/ops/pipeline.py prepare_draw
// (gather_corner_data, geometry.clip_near, corners_to_screen,
// triangle_setup_from_corners, corner_attrs_with_q) and pack_payload. The
// port's plain twin is ops/vertex_batch.py run_pass_plain, about a hundred
// element-wise torch kernels over [T', ...] intermediates in device memory.
//
// What it computes. Thread t is source triangle t of the run, in draw order
// then face order; its draw is found by a binary search over the draws'
// first triangles (the per-draw table that vertex_batch.plan_run builds).
// Per corner: gather vertex faces[t, k] of its draw, clip position by the
// draw's mvp, the mode's columns (world position for flat; the normal by the
// normal matrix, lit with the draw's colour for Gouraud; that normal for
// Phong). Flat lights the face normal cross(w1 - w0, w2 - w0). Then the near
// clip (rows 2t and 2t + 1) or none (row t), the viewport, the triangle
// setup and bbox, the q-premultiplied corners and the payload head. Every
// row is written as the plain pass writes it, invalid rows included.
//
// Op order: every expression is the plain pass's, term by term (FORMULAS.md),
// built with --fmad=false, IEEE divide and sqrt. Where torch's semantics
// differ from C's they are written out: clamp and clamp_min keep a NaN
// (guarded by isnan, as ATen's CUDA kernels are; fminf/fmaxf alone would
// drop it), argmax takes the first index on ties. The bbox's min/max and
// its float-to-int conversion see only finite values (a row with a
// non-finite corner is invalid and takes zeros, as in
// geometry.setup_with_steps), clamped to the frame, where both are exact.
//
// What bounds it on this card: bytes. A triangle reads its faces row and
// three vertices (24 + 3 x 32 bytes for a Gouraud mesh) and writes 217 bytes
// a setup row (coef 64, bbox 16, valid 1, payload 136); its few hundred f32
// operations are far below the card's rate. Every intermediate stays in
// registers (about 100 a thread, no spills), and each vertex is read where
// it lies, at any strides. A thread's rows are 64 and 136 bytes long, so
// storing them from the thread scatters every warp store over 32 rows; the
// design stages each warp's coef and payload rows in shared memory instead
// and writes them back as the contiguous run they are in the outputs, 512
// bytes a warp instruction (`flush`). bbox (one int4) and valid (one byte)
// are stored directly, contiguous across the warp already. On an NVIDIA
// H100 at config 5 (1M rows) the per-thread stores took 0.36 ms, the staged
// ones 0.15, against a bound of 0.10 ms by bytes (PERF.md §6, PR 9).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The per-draw table, i64 [n_draws, kCols] (ops/vertex_batch.py TABLE_*).
constexpr int kCols = 20;
constexpr int kFirst = 0;      // the draw's first triangle in the run
constexpr int kTris = 1;       // its triangles
constexpr int kMode = 2;       // 0 flat, 1 Gouraud, 2 Phong, 3 none
constexpr int kFacesI32 = 3;   // 1: faces are int32, 0: int64
constexpr int kPtr = 4;        // 4 addresses: verts, uv, normals, faces
constexpr int kStride = 8;     // 8 element strides: (row, col) of each
constexpr int kNVerts = 16;    // vertices (a negative index counts back)
constexpr int kModelAt = 17;   // offset of the model matrix in vec
constexpr int kNormalAt = 18;  // offset of the normal matrix in vec
constexpr int kColorAt = 19;   // offset of the colour in vec

constexpr int kFlat = 0, kGouraud = 1, kPhong = 2;
// 2 warps a block; each warp stages its rows' coef and payload in shared
// memory (row strides 17 and 35 words: odd, so the lanes' rows fall in
// distinct banks), 13.3 KB a warp with the near clip (64 rows), 6.7 without
constexpr int kThreads = 64;
constexpr float kNearEps = 1e-4f;    // geometry.NEAR_EPS as f32
constexpr float kBehindW = 1e-6f;    // corners_to_screen's w threshold
constexpr int kCoef = 16, kPayload = 34, kAttrs = 10;
constexpr int kCoefStride = kCoef + 1, kPayStride = kPayload + 1;
constexpr int kRowWords = kCoefStride + kPayStride;

struct Corner {
  float c[4];  // clip position
  float a[9];  // u, v, r, g, b, a, nx, ny, nz (raw, not q-premultiplied)
};

// torch.clamp_min(x, lo) / torch.clamp(x, lo, hi) on CUDA: NaN stays.
__device__ __forceinline__ float clamp_min_t(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_t(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// shading.normalize_exact: v / sqrt(dot(v, v)), a zero (or NaN) dot
// divides by 1.
__device__ __forceinline__ void normalize_exact(float v[3]) {
  const float d = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
  const float s = __fsqrt_rn(d > 0.0f ? d : 1.0f);
  v[0] = v[0] / s;
  v[1] = v[1] / s;
  v[2] = v[2] / s;
}

// shading.light_term: ambient + (1 - ambient) * max(dot(n_hat, l_hat), 0).
__device__ __forceinline__ float light_term(float n[3], const float l[3],
                                            float ambient) {
  normalize_exact(n);
  const float ndl = clamp_min_t((n[0] * l[0] + n[1] * l[1]) + n[2] * l[2],
                                0.0f);
  return ambient + (1.0f - ambient) * ndl;
}

template <typename T>
__device__ __forceinline__ int64_t load_index(const void* p, int64_t at) {
  return static_cast<int64_t>(static_cast<const T*>(p)[at]);
}

// p ? a : b, field by field (constant indices keep corners in registers).
__device__ __forceinline__ Corner pick(bool p, const Corner& a,
                                       const Corner& b) {
  Corner o;
#pragma unroll
  for (int k = 0; k < 4; ++k) o.c[k] = p ? a.c[k] : b.c[k];
#pragma unroll
  for (int k = 0; k < 9; ++k) o.a[k] = p ? a.a[k] : b.a[k];
  return o;
}

// The corner of (c0, c1, c2) that rotation `start` puts first.
__device__ __forceinline__ Corner pick3(int start, const Corner& c0,
                                        const Corner& c1, const Corner& c2) {
  return pick(start == 0, c0, pick(start == 1, c1, c2));
}

// geometry.clip_near's isect(i, j): corner i -> corner j at w = eps.
__device__ __forceinline__ Corner isect(const Corner& ci, const Corner& cj) {
  const float wi = ci.c[3];
  const float denom = cj.c[3] - wi;
  float t = (kNearEps - wi) / (denom == 0.0f ? 1.0f : denom);
  t = clamp_t(t, 0.0f, 1.0f);
  Corner o;
#pragma unroll
  for (int k = 0; k < 4; ++k) o.c[k] = ci.c[k] + (cj.c[k] - ci.c[k]) * t;
#pragma unroll
  for (int k = 0; k < 9; ++k) o.a[k] = ci.a[k] + (cj.a[k] - ci.a[k]) * t;
  return o;
}

// geometry._top_left for the directed edge a -> b.
__device__ __forceinline__ bool top_left(float ax, float ay, float bx,
                                         float by) {
  return ((ay == by) && (bx < ax)) || (by < ay);
}

// One setup row from three clipped corners: corners_to_screen,
// setup_with_steps (coef, bbox, valid & pre_valid), corner_attrs_with_q and
// the payload head. coef and payload go to the warp's staging rows in
// shared memory (s_coef, s_pay), bbox and valid to row `row` of the output.
__device__ __forceinline__ void write_row(
    const Corner& k0, const Corner& k1, const Corner& k2, bool pre_valid,
    const float4 head, int64_t row, int width, int height, bool cull,
    float* s_coef, float* s_pay, int* __restrict__ bbox,
    bool* __restrict__ valid_out) {
  const Corner* ks[3] = {&k0, &k1, &k2};
  float sx[3], sy[3], sz[3], q[3];
  const float half_w = 0.5f * static_cast<float>(width);
  const float half_h = 0.5f * static_cast<float>(height);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = ks[k]->c[3];
    const bool behind = w <= kBehindW;
    q[k] = behind ? 0.0f : 1.0f / (behind ? 1.0f : w);
    const float x_ndc = ks[k]->c[0] * q[k];
    const float y_ndc = ks[k]->c[1] * q[k];
    const float z_ndc = ks[k]->c[2] * q[k];
    sx[k] = (x_ndc + 1.0f) * half_w;
    sy[k] = (1.0f - y_ndc) * half_h;
    sz[k] = (z_ndc + 1.0f) * 0.5f;
  }

  // _edge_coef: A = by - ay, B = ax - bx, C = -(ax*A + ay*B); edge k is
  // opposite corner k.
  float A[3], B[3], C[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int a = (e + 1) % 3, b = (e + 2) % 3;
    A[e] = sy[b] - sy[a];
    B[e] = sx[a] - sx[b];
    C[e] = -(sx[a] * A[e] + sy[a] * B[e]);
  }
  float area2 = (A[2] * sx[2] + B[2] * sy[2]) + C[2];

  const bool any_behind = (q[0] == 0.0f) || (q[1] == 0.0f) || (q[2] == 0.0f);
  const bool finite = isfinite(sx[0]) && isfinite(sy[0]) && isfinite(sx[1])
                      && isfinite(sy[1]) && isfinite(sx[2]) && isfinite(sy[2]);
  bool valid;
  bool flip;
  if (cull) {
    valid = finite && !any_behind && (area2 > 0.0f);
    flip = false;
  } else {
    valid = finite && !any_behind && (area2 != 0.0f);
    flip = area2 < 0.0f;
  }
  const float sgn = flip ? -1.0f : 1.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    A[e] = A[e] * sgn;
    B[e] = B[e] * sgn;
    C[e] = C[e] * sgn;
  }
  area2 = area2 * sgn;
  const float inv_area2 = 1.0f / (valid ? area2 : 1.0f);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int a = (e + 1) % 3, b = (e + 2) % 3;
    const bool tl = flip ? top_left(sx[b], sy[b], sx[a], sy[a])
                         : top_left(sx[a], sy[a], sx[b], sy[b]);
    s_coef[3 * e] = A[e];
    s_coef[3 * e + 1] = B[e];
    s_coef[3 * e + 2] = C[e];
    s_coef[10 + e] = sz[e];
    s_coef[13 + e] = tl ? 1.0f : 0.0f;
  }
  s_coef[9] = inv_area2;

  // Conservative bbox: the corners of a valid row (finite), zeros for any
  // other; min/max, floor/ceil, clamped to [-1, max(w, h)] in float, then
  // the exact conversion, the 1px slack and the frame clamp.
  float xs[3], ys[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xs[k] = valid ? sx[k] : 0.0f;
    ys[k] = valid ? sy[k] : 0.0f;
  }
  const float xmin = fminf(fminf(xs[0], xs[1]), xs[2]);
  const float xmax = fmaxf(fmaxf(xs[0], xs[1]), xs[2]);
  const float ymin = fminf(fminf(ys[0], ys[1]), ys[2]);
  const float ymax = fmaxf(fmaxf(ys[0], ys[1]), ys[2]);
  const float hi = static_cast<float>(width > height ? width : height);
  const int e0 = static_cast<int>(clamp_t(floorf(xmin), -1.0f, hi));
  const int e1 = static_cast<int>(clamp_t(floorf(ymin), -1.0f, hi));
  const int e2 = static_cast<int>(clamp_t(ceilf(xmax), -1.0f, hi));
  const int e3 = static_cast<int>(clamp_t(ceilf(ymax), -1.0f, hi));
  reinterpret_cast<int4*>(bbox)[row] =
      make_int4(min(max(e0 - 1, 0), width - 1), min(max(e1 - 1, 0), height - 1),
                min(max(e2 + 1, 0), width - 1), min(max(e3 + 1, 0), height - 1));
  const bool offscreen = (xmax < 0.0f) || (xmin >= static_cast<float>(width))
                         || (ymax < 0.0f) || (ymin >= static_cast<float>(height));
  valid_out[row] = valid && !offscreen && pre_valid;

  // payload: head, then per corner (q, u*q, v*q, rgba*q, n*q)
  s_pay[0] = head.x;
  s_pay[1] = head.y;
  s_pay[2] = head.z;
  s_pay[3] = head.w;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_pay[4 + k * kAttrs] = q[k];
#pragma unroll
    for (int j = 0; j < 9; ++j) s_pay[5 + k * kAttrs + j] = ks[k]->a[j] * q[k];
  }
}

// Source triangle t: gather, transform and light its corners, clip, and
// stage its row(s) (lane's rows of the warp's staging area).
__device__ __forceinline__ void triangle(
    int64_t t, const int64_t* __restrict__ table,
    const float4* __restrict__ heads, int n_draws,
    const float* __restrict__ vec, const float* __restrict__ mvps,
    int light_at, int width, int height, bool cull, bool near_clip,
    float* s_coef, float* s_pay, int* __restrict__ bbox,
    bool* __restrict__ valid) {
  // the last draw whose first triangle is <= t (a draw of no triangles
  // shares its first with the next draw and is skipped)
  int lo = 0, hi = n_draws - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kCols + kFirst] <= t) lo = mid; else hi = mid - 1;
  }
  const int64_t* d = table + lo * kCols;
  const int64_t local = t - d[kFirst];
  const int mode = static_cast<int>(d[kMode]);
  const float* verts = reinterpret_cast<const float*>(d[kPtr + 0]);
  const float* uv = reinterpret_cast<const float*>(d[kPtr + 1]);
  const float* normals = reinterpret_cast<const float*>(d[kPtr + 2]);
  const void* faces = reinterpret_cast<const void*>(d[kPtr + 3]);
  const int64_t* st = d + kStride;
  const float* mvp = mvps + static_cast<int64_t>(lo) * 16;
  const float* model = vec + d[kModelAt];
  const float* nmat = vec + d[kNormalAt];
  const float* color = vec + d[kColorAt];

  float l_hat[3] = {vec[light_at], vec[light_at + 1], vec[light_at + 2]};
  normalize_exact(l_hat);
  const float ambient = vec[light_at + 3];

  Corner cs[3];
  float world[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t fa = local * st[6] + k * st[7];
    int64_t v = d[kFacesI32] ? load_index<int32_t>(faces, fa)
                             : load_index<int64_t>(faces, fa);
    if (v < 0) v += d[kNVerts];  // torch indexing counts back from the end
    const float x = verts[v * st[0]];
    const float y = verts[v * st[0] + st[1]];
    const float z = verts[v * st[0] + 2 * st[1]];
    // vertex_batch._points: (m_i0*x + m_i1*y) + (m_i2*z + m_i3)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cs[k].c[i] = (mvp[4 * i] * x + mvp[4 * i + 1] * y)
                   + (mvp[4 * i + 2] * z + mvp[4 * i + 3]);
    cs[k].a[0] = uv[v * st[2]];
    cs[k].a[1] = uv[v * st[2] + st[3]];
    cs[k].a[2] = color[0];
    cs[k].a[3] = color[1];
    cs[k].a[4] = color[2];
    cs[k].a[5] = color[3];
    cs[k].a[6] = cs[k].a[7] = cs[k].a[8] = 0.0f;
    if (mode == kFlat) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        world[k][i] = (model[4 * i] * x + model[4 * i + 1] * y)
                      + (model[4 * i + 2] * z + model[4 * i + 3]);
    } else if (mode == kGouraud || mode == kPhong) {
      const float nx = normals[v * st[4]];
      const float ny = normals[v * st[4] + st[5]];
      const float nz = normals[v * st[4] + 2 * st[5]];
      float n[3];
      // vertex_batch._directions: (m_i0*x + m_i1*y) + m_i2*z
#pragma unroll
      for (int i = 0; i < 3; ++i)
        n[i] = (nmat[4 * i] * nx + nmat[4 * i + 1] * ny) + nmat[4 * i + 2] * nz;
      if (mode == kPhong) {
        cs[k].a[6] = n[0];
        cs[k].a[7] = n[1];
        cs[k].a[8] = n[2];
      } else {
        const float term = light_term(n, l_hat, ambient);
        cs[k].a[2] = color[0] * term;
        cs[k].a[3] = color[1] * term;
        cs[k].a[4] = color[2] * term;
      }
    }
  }
  if (mode == kFlat) {  // the face normal cross(w1 - w0, w2 - w0), lit
    float e1[3], e2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e1[i] = world[1][i] - world[0][i];
      e2[i] = world[2][i] - world[0][i];
    }
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    const float term = light_term(n, l_hat, ambient);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cs[k].a[2] = color[0] * term;
      cs[k].a[3] = color[1] * term;
      cs[k].a[4] = color[2] * term;
    }
  }

  const float4 head = heads[lo];
  if (!near_clip) {
    write_row(cs[0], cs[1], cs[2], true, head, t, width, height, cull, s_coef,
              s_pay, bbox, valid);
    return;
  }

  // geometry.clip_near: inside = w >= eps; the canonical rotation puts the
  // one inside corner (cnt 1) at 0, the one outside corner (cnt 2) at 2.
  bool inside[3];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inside[k] = cs[k].c[3] >= kNearEps;
    cnt += inside[k] ? 1 : 0;
  }
  const int in_idx = inside[0] ? 0 : (inside[1] ? 1 : (inside[2] ? 2 : 0));
  const int out_idx = !inside[0] ? 0 : (!inside[1] ? 1 : (!inside[2] ? 2 : 0));
  const int start = cnt == 1 ? in_idx : (cnt == 2 ? (out_idx + 1) % 3 : 0);
  const Corner r0 = pick3(start, cs[0], cs[1], cs[2]);
  const Corner r1 = pick3(start, cs[1], cs[2], cs[0]);
  const Corner r2 = pick3(start, cs[2], cs[0], cs[1]);
  const Corner ab = isect(r0, r1);
  const Corner ac = isect(r0, r2);
  const Corner bc = isect(r1, r2);
  // slot 0: (A, B, BC) for cnt 2, (A, AB, AC) for cnt 1, else as rotated;
  // slot 1: (A, BC, AC) always, valid only for cnt 2
  const Corner s1 = pick(cnt == 1, ab, r1);
  const Corner s2 = pick(cnt == 2, bc, pick(cnt == 1, ac, r2));
  write_row(r0, s1, s2, cnt >= 1, head, 2 * t, width, height, cull, s_coef,
            s_pay, bbox, valid);
  write_row(r0, bc, ac, cnt == 2, head, 2 * t + 1, width, height, cull,
            s_coef + kCoefStride, s_pay + kPayStride, bbox, valid);
}

// Copy n_words floats of a warp's staged rows (row stride `stride` in shared
// memory, `width` words a row) to dst (16-byte aligned, rows packed): each
// lane stores float4s, the warp 512 contiguous bytes an instruction.
template <int width, int stride>
__device__ __forceinline__ void flush(const float* src, float* __restrict__ dst,
                                      int n_words, int lane) {
  for (int e = 4 * lane; e < n_words; e += 128) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = min(e + j, n_words - 1);  // the tail repeats its last
      v[j] = src[(w / width) * stride + w % width];
    }
    if (e + 4 <= n_words) {
      *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; e + j < n_words; ++j) dst[e + j] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
vertex_pass_kernel(const int64_t* __restrict__ table,
                   const float4* __restrict__ heads, int n_draws,
                   int64_t n_tris, const float* __restrict__ vec,
                   const float* __restrict__ mvps, int light_at, int width,
                   int height, int cull, int near_clip,
                   float* __restrict__ coef, int* __restrict__ bbox,
                   bool* __restrict__ valid, float* __restrict__ payload) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int per_tri = near_clip ? 2 : 1;
  const int warp_rows = 32 * per_tri;
  float* s_pay = smem + (threadIdx.x >> 5) * warp_rows * kRowWords;
  float* s_coef = s_pay + warp_rows * kPayStride;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n_tris) {
    const int r = lane * per_tri;
    triangle(t, table, heads, n_draws, vec, mvps, light_at, width, height,
             cull != 0, near_clip != 0, s_coef + r * kCoefStride,
             s_pay + r * kPayStride, bbox, valid);
  }
  __syncwarp();
  // the warp's rows are contiguous in the outputs: write them back whole
  const int64_t row0 = (t - lane) * per_tri;
  const int64_t n_rows = n_tris * per_tri;
  if (row0 >= n_rows) return;
  const int rows = static_cast<int>(min(static_cast<int64_t>(warp_rows),
                                        n_rows - row0));
  flush<kPayload, kPayStride>(s_pay, payload + row0 * kPayload,
                              rows * kPayload, lane);
  flush<kCoef, kCoefStride>(s_coef, coef + row0 * kCoef, rows * kCoef, lane);
}

}  // namespace

extern "C" cudaError_t dtr_vertex_pass(
    const int64_t* table, const float* heads, int n_draws, int64_t n_tris,
    const float* vec, const float* mvps, int light_at, int width, int height,
    int cull, int near_clip, float* coef, int* bbox, bool* valid,
    float* payload, void* stream) {
  if (n_tris <= 0 || n_draws <= 0) return cudaSuccess;
  const int64_t blocks = (n_tris + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (kThreads / 32) * 32 *
                      (near_clip ? 2 : 1) * kRowWords;
  vertex_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      table, reinterpret_cast<const float4*>(heads), n_draws, n_tris, vec,
      mvps, light_at, width, height, cull, near_clip, coef, bbox, valid,
      payload);
  return cudaGetLastError();
}

extern "C" int dtr_vertex_pass_table_cols() { return kCols; }

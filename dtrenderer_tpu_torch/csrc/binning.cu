// Triangle -> framebuffer-tile binning into CSR lists, for Hopper (sm_90a).
//
// Replaces the binning that the JAX package leaves to XLA:
// dtrenderer_tpu/ops/binning.py:859 bin_triangles (sort-based, XLA ops, a
// fixed capacity per tile; no pl.pallas_call). The port's plain twin is
// ops/binning.py bin_triangles_plain: about 70 eager torch ops, one int64
// sort of the keys tile * T + id, and two host synchronises (the output
// length of repeat_interleave, the max that bincount reads).
//
// What it computes: the same Bins, bit for bit. Every in-shard triangle
// emits one (tile, triangle) pair per tile of its clamped bbox's span over
// the (banded) tile grid; tile_start[t] is where tile t's ids begin and
// each tile's ids ascend. The host side (ops/binning.py bin_on_card) runs:
//
//   1. bin_cover_kernel, one thread per triangle: the in-shard test, the
//      clamps and the banded tile rows of the plain twin's _emit_pairs in
//      int32, exactly as torch computes them; n_cover[t] = the tiles of its
//      span (0 out of the shard);
//   2. torch.cumsum of n_cover (int64) into the pairs' ends; the one read
//      back to the host is the pair count P = ends[T - 1];
//   3. bin_pairs_kernel, one thread per pair k: its triangle is the first
//      t with ends[t] > k (a binary search), its tile comes from k's place
//      in the span (row k' / span_w, column k' % span_w, k' = k minus the
//      triangle's first pair). It writes key = tile and value = t in pair
//      order, which is ascending id within every tile, and counts the pair
//      into its tile (an atomic add into counts[1 + tile]); torch.cumsum of
//      the counts is tile_start;
//   4. dtr_bin_sort: a stable radix sort of the pairs by tile over the
//      tile's bits only (CUB DeviceRadixSort::SortPairs with end_bit =
//      bit_length(n_tiles - 1): 15 bits at 4K, two passes). A stable sort
//      on the tile of pairs emitted in id order is the plain twin's sort on
//      tile * T + id.
//
// One thread per pair (and not per triangle) in step 3 keeps a full-screen
// triangle (8,160 tiles at 1080p) from serialising on one thread. A bbox
// with x0 > x1 or y0 > y1 on a valid row, which triangle setup never makes,
// bins nothing here (its span is not positive); the plain twin raises or
// emits pairs of a negative span for it.
//
// What bounds it on this card: bytes, and launch latency below a few
// hundred thousand pairs. The function must read bbox and valid (17 bytes
// a triangle) and write tile_start and tri_ids (4 bytes a tile, 4 a pair);
// the design moves n_cover and the ends (8 + 16 bytes a triangle), bbox
// again in step 3 (a pair reads its triangle's row, shared by the span's
// consecutive pairs through L1), the pairs (8 bytes, an atomic) and the
// sort's passes over key and value (32 bytes a pair a pass). At config 5
// (1M triangles, 4K) that is tens of MB, a few tens of microseconds at the
// card's 3.35 TB/s, against the plain twin's 64-bit sort of eight passes.

#include <cstdint>
#include <cuda_runtime.h>
// CUB (and the Thrust headers it includes) in a namespace of their own,
// so that its kernels cannot meet the CUB that PyTorch's libraries carry
// in the same process
#define THRUST_WRAPPED_NAMESPACE dtr_binning
#define CUB_WRAPPED_NAMESPACE dtr_binning
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;

// The banded tile grid of one [height, width] shard at (y_offset,
// x_offset): row_bands bands of band_h rows, n_tyb tile rows a band, n_tx
// tile columns (ops/binning.py _emit_pairs).
struct Grid {
  int height, width, y_offset, x_offset, tile_h, tile_w, band_h, n_tyb, n_tx;
};

inline Grid make_grid(int height, int width, int y_offset, int x_offset,
                      int tile_h, int tile_w, int row_bands) {
  const int band_h = height / row_bands;
  return Grid{height, width, y_offset, x_offset, tile_h, tile_w, band_h,
              (band_h + tile_h - 1) / tile_h, (width + tile_w - 1) / tile_w};
}

// torch's int32 subtraction wraps; C++'s signed overflow is undefined.
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int tile_row(int y, const Grid& g) {
  const int band = y / g.band_h;
  return band * g.n_tyb + (y - band * g.band_h) / g.tile_h;
}

// Triangle t's span over the grid: its first tile column and row and the
// span's width; returns the tiles it covers (0 out of the shard).
__device__ __forceinline__ int span_of(const int4 b, bool valid,
                                       const Grid& g, int* tx0, int* ty0,
                                       int* span_w) {
  const bool in_shard = valid && b.z >= g.x_offset &&
                        b.x < g.x_offset + g.width && b.w >= g.y_offset &&
                        b.y < g.y_offset + g.height;
  const int x0 = clamp_i(sub_wrap(b.x, g.x_offset), 0, g.width - 1);
  const int y0 = clamp_i(sub_wrap(b.y, g.y_offset), 0, g.height - 1);
  const int x1 = clamp_i(sub_wrap(b.z, g.x_offset), 0, g.width - 1);
  const int y1 = clamp_i(sub_wrap(b.w, g.y_offset), 0, g.height - 1);
  *tx0 = x0 / g.tile_w;
  *ty0 = tile_row(y0, g);
  *span_w = x1 / g.tile_w - *tx0 + 1;
  const int span_h = tile_row(y1, g) - *ty0 + 1;
  return in_shard && *span_w > 0 && span_h > 0 ? *span_w * span_h : 0;
}

__global__ void __launch_bounds__(kThreads)
bin_cover_kernel(const int4* __restrict__ bbox,
                 const bool* __restrict__ valid, int64_t n_tris, Grid g,
                 int64_t* __restrict__ n_cover) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_tris) return;
  int tx0, ty0, span_w;
  n_cover[t] = span_of(bbox[t], valid[t], g, &tx0, &ty0, &span_w);
}

__global__ void __launch_bounds__(kThreads)
bin_pairs_kernel(const int4* __restrict__ bbox,
                 const bool* __restrict__ valid,
                 const int64_t* __restrict__ ends, int64_t n_tris,
                 int64_t n_pairs, Grid g, unsigned* __restrict__ tile_of,
                 int* __restrict__ tri_of, int* __restrict__ counts) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n_pairs) return;
  int64_t lo = 0, hi = n_tris - 1;  // the first t with ends[t] > k
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ends[mid] > k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int64_t first = lo > 0 ? ends[lo - 1] : 0;
  int tx0, ty0, span_w;
  span_of(bbox[lo], valid[lo], g, &tx0, &ty0, &span_w);
  const int64_t kk = k - first;
  const int64_t tile = (ty0 + kk / span_w) * g.n_tx + (tx0 + kk % span_w);
  tile_of[k] = static_cast<unsigned>(tile);
  tri_of[k] = static_cast<int>(lo);
  atomicAdd(counts + tile + 1, 1);
}

}  // namespace

extern "C" cudaError_t dtr_bin_cover(const int* bbox, const bool* valid,
                                     int64_t n_tris, int height, int width,
                                     int y_offset, int x_offset, int tile_h,
                                     int tile_w, int row_bands,
                                     int64_t* n_cover, void* stream) {
  if (n_tris <= 0) return cudaSuccess;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const int64_t blocks = (n_tris + kThreads - 1) / kThreads;
  bin_cover_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(bbox), valid, n_tris, g, n_cover);
  return cudaGetLastError();
}

extern "C" cudaError_t dtr_bin_pairs(const int* bbox, const bool* valid,
                                     const int64_t* ends, int64_t n_tris,
                                     int64_t n_pairs, int height, int width,
                                     int y_offset, int x_offset, int tile_h,
                                     int tile_w, int row_bands, int* tile_of,
                                     int* tri_of, int* counts, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const int64_t blocks = (n_pairs + kThreads - 1) / kThreads;
  bin_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(bbox), valid, ends, n_tris, n_pairs, g,
      reinterpret_cast<unsigned*>(tile_of), tri_of, counts);
  return cudaGetLastError();
}

// CUB's two-phase call: with temp == nullptr it only writes the scratch
// bytes the sort needs into *temp_bytes.
extern "C" cudaError_t dtr_bin_sort(void* temp, size_t* temp_bytes,
                                    const int* keys_in, int* keys_out,
                                    const int* values_in, int* values_out,
                                    int n_pairs, int end_bit, void* stream) {
  return CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(
      temp, *temp_bytes, reinterpret_cast<const unsigned*>(keys_in),
      reinterpret_cast<unsigned*>(keys_out), values_in, values_out, n_pairs,
      0, end_bit, static_cast<cudaStream_t>(stream));
}

// Triangle -> framebuffer-tile binning into CSR lists, for Hopper (sm_90a).
//
// Replaces the binning that the JAX package leaves to XLA:
// dtrenderer_tpu/ops/binning.py:859 bin_triangles (sort-based, XLA ops, a
// fixed capacity per tile; no pl.pallas_call). The port's plain twin is
// ops/binning.py bin_triangles_plain: about 70 eager torch ops, one int64
// sort of the keys tile * T + id, and host synchronises of its own.
//
// What it computes: the same Bins, bit for bit. Every in-shard triangle
// emits one (tile, triangle) pair per tile of its clamped bbox's span over
// the (banded) tile grid; tile_start[t] is where tile t's ids begin and
// each tile's ids ascend. A span that is not positive (x1's tile column
// before x0's, or y1's tile row before y0's: an inverted bbox) bins
// nothing, here and in the twin. The host side (ops/binning.py
// bin_on_card) makes two calls around one read:
//
//   dtr_bin_scan (one memset, one kernel):
//     bin_scan_kernel, a single-pass scan. A block takes kBudget triangles
//     (its slot from an atomic ticket, so that a block waits only on blocks
//     that started before it), counts each one's tiles (span_of: the
//     in-shard test, the clamps and the banded tile rows of the twin's
//     _emit_pairs in int32), scans the counts in shared memory, and gets
//     the sum of every earlier slot by a decoupled look-back over one
//     status word a slot, read kThreads words at a time by the whole
//     block. It writes the pairs' int64 ends (inclusive) and, from the
//     last slot, the pair count P, the one value read back.
//   dtr_bin_emit (the emit kernel, CUB's sort, one kernel):
//     bin_emit_kernel, merge-path load balancing: the merged sequence of
//     the T triangle ends and the P pair indices is cut into runs of
//     kBudget items, one a block. The block finds its run's two ends on
//     the merge path by one search over `ends` (each half of the block
//     probes one end, 128 loads a round: the only global search), stages
//     its triangles' ends and spans in shared memory, and each thread finds
//     a pair's triangle by a binary search there. A pair's tile is k's
//     place in the span (row k / span_w, column k % span_w, k the pair's
//     index within its triangle). tile_of and tri_of are written coalesced
//     in pair order, which is ascending id within every tile. A full-screen
//     triangle spreads over many blocks, a long run of zero-cover triangles
//     over few: either way a block holds kBudget items. No global atomics.
//     CUB's DeviceRadixSort::SortPairs, stable, on the tile's bits only
//     (end_bit = bit_length(n_tiles - 1): 15 bits at 4K, two passes): a
//     stable sort on the tile of pairs emitted in id order is the twin's
//     sort on tile * T + id.
//     bin_starts_kernel, four sorted pairs a thread: where a pair's tile
//     differs from the previous pair's, tile_start of every tile in
//     between is the pair's index; after the last pair it is P. Long runs
//     of empty tiles are written by the whole block. It also writes the
//     overflow word (0) that follows tile_start.
//
// What bounds it on this card: bytes, and launch latency below a few
// hundred thousand pairs. The function must read bbox and valid (17 bytes
// a triangle) and write tile_start and tri_ids (4 bytes a tile, 4 a pair);
// the design moves the ends (8 bytes a triangle, written once and read
// twice), bbox again in the emit, the unsorted pairs (8 bytes, written
// once), the sort's passes over key and value, and the sorted keys once
// more for the tile starts. On an H100 at 1M triangles (3.16M pairs) CUB's
// three passes are over half of the time; below some 20k triangles every
// pass is a few microseconds of latency.

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
constexpr int kPerThread = 4;
// Triangles a scan block takes, and items (triangle ends + pairs) of the
// merged sequence an emit block takes.
constexpr int kBudget = kThreads * kPerThread;

// A look-back status word: a flag in the top two bits, a sum below.
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1;  // the slot's own sum
constexpr unsigned long long kPrefix = 2;     // the sum of slots 0..slot
constexpr unsigned long long kValueMask = (1ull << kFlagShift) - 1;

// The banded tile grid of one [height, width] shard at (y_offset,
// x_offset): row_bands bands of band_h rows, n_tyb tile rows a band, n_tx
// tile columns (ops/binning.py _emit_pairs).
struct Grid {
  int height, width, y_offset, x_offset, tile_h, tile_w, band_h, n_tyb, n_tx,
      n_tiles;
};

inline Grid make_grid(int height, int width, int y_offset, int x_offset,
                      int tile_h, int tile_w, int row_bands) {
  const int band_h = height / row_bands;
  const int n_tyb = (band_h + tile_h - 1) / tile_h;
  const int n_tx = (width + tile_w - 1) / tile_w;
  return Grid{height, width,  y_offset, x_offset, tile_h,
              tile_w, band_h, n_tyb,    n_tx,     row_bands * n_tyb * n_tx};
}

// The bits CUB sorts: bit_length(n_tiles - 1), at least 1.
inline int end_bit(const Grid& g) {
  int bits = 1;
  while (bits < 31 && (g.n_tiles - 1) >> bits) ++bits;
  return bits;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
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

// Triangle t's span over the grid: its first tile (row-major index) and the
// span's width; returns the tiles it covers (0 out of the shard or for a
// span that is not positive).
__device__ __forceinline__ int span_of(const int4 b, bool valid,
                                       const Grid& g, int* first_tile,
                                       int* span_w) {
  const bool in_shard = valid && b.z >= g.x_offset &&
                        b.x < g.x_offset + g.width && b.w >= g.y_offset &&
                        b.y < g.y_offset + g.height;
  const int x0 = clamp_i(sub_wrap(b.x, g.x_offset), 0, g.width - 1);
  const int y0 = clamp_i(sub_wrap(b.y, g.y_offset), 0, g.height - 1);
  const int x1 = clamp_i(sub_wrap(b.z, g.x_offset), 0, g.width - 1);
  const int y1 = clamp_i(sub_wrap(b.w, g.y_offset), 0, g.height - 1);
  const int tx0 = x0 / g.tile_w;
  const int ty0 = tile_row(y0, g);
  *first_tile = ty0 * g.n_tx + tx0;
  *span_w = x1 / g.tile_w - tx0 + 1;
  const int span_h = tile_row(y1, g) - ty0 + 1;
  return in_shard && *span_w > 0 && span_h > 0 ? *span_w * span_h : 0;
}

// One padding word every 32 (int) or 16 (int64) entries, so that a warp's
// threads reading kPerThread consecutive entries each meet distinct banks.
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }
__device__ __forceinline__ int pad64(int i) { return i + (i >> 4); }

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long flag,
                                        int64_t value) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(word) =
      (flag << kFlagShift) | static_cast<unsigned long long>(value);
}

// Decoupled look-back, by the whole block, for slot `slot`: the sum of
// every earlier slot's count. The block reads the kThreads words before
// the slot at once (each thread waits on its word until it has a flag:
// every earlier slot belongs to a block that has started, the ticket's
// order, so the wait ends), then reduces them nearest first, stopping at
// the first word that holds a prefix; a window without one adds its sum
// and the next window goes on further back. Every thread gets the sum.
__device__ int64_t look_back(const unsigned long long* status, int64_t slot) {
  __shared__ bool s_prefix[kThreads];
  __shared__ int64_t s_value[kThreads];
  const int tid = threadIdx.x;
  int64_t before = 0;
  for (int64_t top = slot - 1; top >= 0; top -= kThreads) {
    const int64_t j = top - tid;
    unsigned long long word = kPrefix << kFlagShift;  // before slot 0: 0
    if (j >= 0) {
      do {
        word = read_status(status + j);
      } while ((word >> kFlagShift) == 0);
    }
    s_prefix[tid] = (word >> kFlagShift) == kPrefix;
    s_value[tid] = static_cast<int64_t>(word & kValueMask);
    __syncthreads();
    // (prefix, sum) of words tid..tid + 2 * off - 1, the nearest first
    for (int off = 1; off < kThreads; off <<= 1) {
      if (tid % (2 * off) == 0 && !s_prefix[tid]) {
        s_value[tid] += s_value[tid + off];
        s_prefix[tid] = s_prefix[tid + off];
      }
      __syncthreads();
    }
    before += s_value[0];
    const bool found = s_prefix[0];
    __syncthreads();  // the window's words are read: the next may reuse them
    if (found) break;
  }
  return before;
}

// ends[t] = the pairs of triangles 0..t; *n_pairs = ends[n_tris - 1]. The
// status words and the ticket are zero at launch.
__global__ void __launch_bounds__(kThreads)
bin_scan_kernel(const int4* __restrict__ bbox,
                const bool* __restrict__ valid, int64_t n_tris, Grid g,
                int64_t* __restrict__ ends, int64_t* __restrict__ n_pairs,
                unsigned long long* status, unsigned* ticket) {
  __shared__ int s_cnt[kBudget + kBudget / 32];
  __shared__ int64_t s_end[kBudget + kBudget / 16];
  __shared__ int64_t s_sum[2][kThreads];
  __shared__ unsigned s_slot;
  const int tid = threadIdx.x;
  if (tid == 0) s_slot = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t slot = s_slot;
  const int64_t base = slot * kBudget;
  // every load first, then the counts: kPerThread loads in flight
  int4 box[kPerThread];
  bool ok[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t t = base + k * kThreads + tid;
    ok[k] = t < n_tris && valid[t];
    if (t < n_tris) box[k] = bbox[t];
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    int first_tile, span_w;
    s_cnt[pad32(k * kThreads + tid)] =
        ok[k] ? span_of(box[k], true, g, &first_tile, &span_w) : 0;
  }
  __syncthreads();
  // this thread's kPerThread consecutive triangles, then a block scan of
  // the threads' sums (Hillis-Steele, two buffers)
  int64_t own = 0;
  for (int k = 0; k < kPerThread; ++k)
    own += s_cnt[pad32(tid * kPerThread + k)];
  int src = 0;
  s_sum[0][tid] = own;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    int64_t v = s_sum[src][tid];
    if (tid >= off) v += s_sum[src][tid - off];
    s_sum[src ^ 1][tid] = v;
    src ^= 1;
    __syncthreads();
  }
  const int64_t inclusive = s_sum[src][tid];
  const int64_t aggregate = s_sum[src][kThreads - 1];
  if (tid == 0) publish(status + slot, slot == 0 ? kPrefix : kAggregate,
                        aggregate);
  const int64_t before = look_back(status, slot);
  if (tid == 0 && slot > 0) publish(status + slot, kPrefix, before + aggregate);
  if (tid == 0 && base + kBudget >= n_tris) *n_pairs = before + aggregate;
  int64_t run = before + inclusive - own;
  for (int k = 0; k < kPerThread; ++k) {
    run += s_cnt[pad32(tid * kPerThread + k)];
    s_end[pad64(tid * kPerThread + k)] = run;
  }
  __syncthreads();
  for (int k = 0; k < kPerThread; ++k) {
    const int i = k * kThreads + tid;
    if (base + i < n_tris) ends[base + i] = s_end[pad64(i)];
  }
}

// The merge path of the triangle ends and the pair indices 0..n_pairs-1
// (a triangle's end goes before pair j when ends[t] <= j): the triangles
// among the first d items (the pairs among them are d minus that), for
// the block's two diagonals d0 and d1 at once, into split[0] and split[1].
// Each half of the block narrows one diagonal's range [lo, hi] by a
// kProbes-ary search: every thread tests one probe (one load, all in
// flight together), and the first probe that fails bounds the answer. At
// 1M triangles that is three rounds where a binary search takes twenty
// dependent loads.
__device__ void merge_splits(const int64_t* ends, int64_t n_tris,
                             int64_t n_pairs, int64_t d0, int64_t d1,
                             int64_t* split) {
  constexpr int kProbes = kThreads / 2;
  __shared__ int64_t s_lo[2], s_hi[2];
  __shared__ bool s_pass[kThreads];
  const int tid = threadIdx.x, half = tid / kProbes, lane = tid % kProbes;
  const int64_t d = half == 0 ? d0 : d1;
  if (lane == 0) {
    s_lo[half] = max64(d - n_pairs, 0);
    s_hi[half] = min64(d, n_tris);
  }
  __syncthreads();
  while (s_lo[0] < s_hi[0] || s_lo[1] < s_hi[1]) {
    const int64_t lo = s_lo[half], hi = s_hi[half];
    const int64_t step = (hi - lo + kProbes - 1) / kProbes;
    const int64_t x = lo + lane * step;
    // passes: triangle x's end comes before the diagonal's next pair
    const bool pass = x < hi && ends[x] <= d - x - 1;
    s_pass[tid] = pass;
    __syncthreads();
    if (lo < hi) {
      if (!pass && (lane == 0 || s_pass[tid - 1])) {  // the first failure
        if (lane > 0) s_lo[half] = x - step + 1;
        s_hi[half] = min64(x, hi);
      } else if (pass && lane == kProbes - 1) {  // no failure
        s_lo[half] = x + 1;
      }
    }
    __syncthreads();
  }
  if (lane == 0) split[half] = s_lo[half];
}

// Block b emits the pairs of items [b * kBudget, (b + 1) * kBudget) of the
// merged sequence: tile_of[k] and tri_of[k] for each of its pairs k. Pair
// indices fit in int32 here (P < 2^31).
__global__ void __launch_bounds__(kThreads)
bin_emit_kernel(const int4* __restrict__ bbox,
                const bool* __restrict__ valid,
                const int64_t* __restrict__ ends, int64_t n_tris,
                int64_t n_pairs, Grid g, unsigned* __restrict__ tile_of,
                int* __restrict__ tri_of) {
  // triangle i0 + x: s_end[1 + x] = ends[i0 + x] (s_end[0] its first
  // pair), s_tile[x] and s_span[x] its first tile and span width
  __shared__ int s_end[kBudget + 2];
  __shared__ int s_tile[kBudget + 1];
  __shared__ int s_span[kBudget + 1];
  __shared__ int64_t s_split[2];
  const int tid = threadIdx.x;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kBudget;
  const int64_t d1 = min64(d0 + kBudget, n_tris + n_pairs);
  merge_splits(ends, n_tris, n_pairs, d0, d1, s_split);
  __syncthreads();
  const int64_t i0 = s_split[0], i1 = s_split[1];
  // pairs j0..j1-1 belong to triangles i0..min(i1, n_tris - 1), n_t of them
  const int j0 = static_cast<int>(d0 - i0), j1 = static_cast<int>(d1 - i1);
  const int n_t = static_cast<int>(min64(i1, n_tris - 1) - i0 + 1);
  if (j0 < j1) {
    for (int x = tid; x < n_t; x += kThreads) {
      s_end[1 + x] = static_cast<int>(ends[i0 + x]);
      span_of(bbox[i0 + x], valid[i0 + x], g, &s_tile[x], &s_span[x]);
    }
    if (tid == 0) s_end[0] = i0 > 0 ? static_cast<int>(ends[i0 - 1]) : 0;
  }
  __syncthreads();
  int lo = 0;  // a thread's pairs ascend, and so do their triangles
  for (int j = j0 + tid; j < j1; j += kThreads) {
    int hi = n_t - 1;  // the first x with s_end[1 + x] > j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_end[1 + mid] > j) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int k = j - s_end[lo];
    const int span_w = s_span[lo];
    const int row = k / span_w;
    tile_of[j] = static_cast<unsigned>(s_tile[lo] + row * g.n_tx +
                                       (k - row * span_w));
    tri_of[j] = static_cast<int>(i0 + lo);
  }
}

// tile_start[0..n_tiles] from the sorted tiles of n_pairs > 0 pairs, and
// tile_start[n_tiles + 1] (the overflow word) = 0. A thread takes
// kStartsPerThread consecutive pairs (one 16-byte load; keys is 256-byte
// aligned); where a pair's tile differs from the previous pair's, the
// tiles in between (empty ones, then its own) start at the pair, and
// after the last pair every tile starts at n_pairs. A run of more than
// kShortRun tiles (empty screen before, between or after the pairs) is
// listed in shared memory and written by the whole block.
constexpr int kStartsPerThread = 4;
constexpr int kShortRun = 32;

__global__ void __launch_bounds__(kThreads)
bin_starts_kernel(const unsigned* __restrict__ keys, int n_pairs,
                  int n_tiles, int* __restrict__ tile_start) {
  constexpr int kRuns = kThreads * (kStartsPerThread + 1);
  __shared__ int s_runs;
  __shared__ int s_first[kRuns], s_last[kRuns], s_start[kRuns];
  const int tid = threadIdx.x;
  const int64_t k0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + tid) * kStartsPerThread;
  if (tid == 0) s_runs = 0;
  __syncthreads();
  // tiles first..last start at `start`
  auto fill = [&](int first, int last, int start) {
    if (last - first < kShortRun) {
      for (int t = first; t <= last; ++t) tile_start[t] = start;
    } else {
      const int r = atomicAdd(&s_runs, 1);
      s_first[r] = first;
      s_last[r] = last;
      s_start[r] = start;
    }
  };
  if (k0 < n_pairs) {
    unsigned key[kStartsPerThread];
    if (k0 + kStartsPerThread <= n_pairs) {
      const uint4 v = *reinterpret_cast<const uint4*>(keys + k0);
      key[0] = v.x, key[1] = v.y, key[2] = v.z, key[3] = v.w;
    } else {
      for (int q = 0; q < kStartsPerThread; ++q)
        key[q] = k0 + q < n_pairs ? keys[k0 + q] : 0;
    }
    int after = k0 > 0 ? static_cast<int>(keys[k0 - 1]) + 1 : 0;
    for (int q = 0; q < kStartsPerThread && k0 + q < n_pairs; ++q) {
      const int tile = static_cast<int>(key[q]);
      if (tile >= after) fill(after, tile, static_cast<int>(k0 + q));
      after = tile + 1;
    }
    if (k0 + kStartsPerThread >= n_pairs) fill(after, n_tiles, n_pairs);
    if (k0 == 0) tile_start[n_tiles + 1] = 0;
  }
  __syncthreads();
  for (int r = 0; r < s_runs; ++r) {
    for (int t = s_first[r] + tid; t <= s_last[r]; t += kThreads)
      tile_start[t] = s_start[r];
  }
}

inline size_t align256(size_t n) { return (n + 255) & ~size_t{255}; }

}  // namespace

// Triangles a scan block takes: bin_on_card sizes the scan's work buffer
// with it.
extern "C" int dtr_bin_budget() { return kBudget; }

// work (int64): ends [n_tris], P [1], one status word a scan block, the
// ticket [1]. Clears the status words and the ticket, then scans.
extern "C" cudaError_t dtr_bin_scan(const int* bbox, const bool* valid,
                                    int64_t n_tris, int height, int width,
                                    int y_offset, int x_offset, int tile_h,
                                    int tile_w, int row_bands, int64_t* work,
                                    void* stream) {
  if (n_tris <= 0) return cudaSuccess;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n_tris + kBudget - 1) / kBudget;
  int64_t* status = work + n_tris + 1;
  const cudaError_t err =
      cudaMemsetAsync(status, 0, (blocks + 1) * sizeof(int64_t), s);
  if (err != cudaSuccess) return err;
  bin_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      reinterpret_cast<const int4*>(bbox), valid, n_tris, g, work,
      work + n_tris, reinterpret_cast<unsigned long long*>(status),
      reinterpret_cast<unsigned*>(status + blocks));
  return cudaGetLastError();
}

// The scratch bytes dtr_bin_emit needs for n_pairs pairs: CUB's (a query on
// the host, no launch), then tile_of, tri_of and the sorted tiles.
extern "C" cudaError_t dtr_bin_scratch_bytes(int64_t n_pairs, int height,
                                             int width, int y_offset,
                                             int x_offset, int tile_h,
                                             int tile_w, int row_bands,
                                             size_t* bytes) {
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  size_t temp = 0;
  const cudaError_t err = CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(
      nullptr, temp, static_cast<const unsigned*>(nullptr),
      static_cast<unsigned*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), static_cast<int>(n_pairs), 0, end_bit(g));
  *bytes = align256(temp) + 3 * align256(n_pairs * sizeof(int));
  return err;
}

// After the read of P (n_pairs > 0): the emit, CUB's stable sort of the
// pairs by tile into tri_ids, and tile_start [n_tiles + 2] (the last word
// is the overflow count, 0).
extern "C" cudaError_t dtr_bin_emit(const int* bbox, const bool* valid,
                                    const int64_t* work, int64_t n_tris,
                                    int64_t n_pairs, int height, int width,
                                    int y_offset, int x_offset, int tile_h,
                                    int tile_w, int row_bands, void* scratch,
                                    size_t scratch_bytes, int* tile_start,
                                    int* tri_ids, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t array = align256(n_pairs * sizeof(int));
  if (scratch_bytes < 3 * array) return cudaErrorInvalidValue;
  size_t temp = scratch_bytes - 3 * array;
  char* at = static_cast<char*>(scratch) + temp;
  unsigned* tile_of = reinterpret_cast<unsigned*>(at);
  int* tri_of = reinterpret_cast<int*>(at + array);
  unsigned* keys = reinterpret_cast<unsigned*>(at + 2 * array);
  const int64_t emit_blocks = (n_tris + n_pairs + kBudget - 1) / kBudget;
  bin_emit_kernel<<<static_cast<unsigned>(emit_blocks), kThreads, 0, s>>>(
      reinterpret_cast<const int4*>(bbox), valid, work, n_tris, n_pairs, g,
      tile_of, tri_of);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = CUB_NS_QUALIFIER::DeviceRadixSort::SortPairs(
      scratch, temp, tile_of, keys, tri_of, tri_ids,
      static_cast<int>(n_pairs), 0, end_bit(g), s);
  if (err != cudaSuccess) return err;
  const int64_t per_block = kThreads * kStartsPerThread;
  bin_starts_kernel<<<static_cast<unsigned>((n_pairs + per_block - 1) /
                                            per_block),
                      kThreads, 0, s>>>(keys, static_cast<int>(n_pairs),
                                        g.n_tiles, tile_start);
  return cudaGetLastError();
}

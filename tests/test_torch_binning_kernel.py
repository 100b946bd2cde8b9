"""The binning kernels (csrc/binning.cu) and their host side in
ops/binning.py.

Bars:
  * `bin_triangles` on a CPU tensor is `bin_triangles_plain` and launches
    nothing; on a device that is neither CPU nor CUDA it raises, and
    `bin_on_card` raises on inputs the kernels do not read: no fallback;
  * csrc/binning.cu itself, compiled for the host with g++ and a few shims
    (one OS thread per CUDA thread of a block, the blocks one after
    another, shared memory as static arrays, a barrier for __syncthreads,
    and a stable sort on the key's low bits in place of CUB's radix sort),
    driven by `bin_on_card` exactly as on the card, gives the Bins of
    `bin_triangles_plain` bit for bit (tile_start, tri_ids, overflow) on:
    random soups over shards at offsets and several tiles, the banded grids
    of tests/test_torch_binning.py (270-row bands of 17 tile rows among
    them), empty and off-screen scenes, the shapes of models/stress.py (the
    686-deep pile and the edge grids, whole and in windows), the
    `huge_vertices` and `nonfinite_uvs` cases of models/edge_cases.py, a
    full-screen triangle, no pair at all, one triangle, random bboxes
    (hypothesis), inverted bboxes on valid rows, and the edges of the
    blocks' budgets (a block that starts mid-triangle, one triangle over
    several blocks, a zero-cover run longer than a budget, P and T + P
    exact multiples of it, a scan over more than three blocks); the scan's
    look-back alone over status words that blocks in flight leave.
    Checked without a card (skipped where there is no g++);
  * the plain path bins an inverted bbox (a tile span that is not
    positive) as empty;
  * nothing of the new modules imports JAX or the JAX package;
  * on the card (`gpu`): the kernel against its twin on random soups, the
    stress shapes, the edge cases, the budgets' edges and inverted bboxes,
    one host synchronise a call where
    the plain path has more (four calls that synchronise, counted under
    torch's sync debug mode), and one count a call (python -m pytest
    --noconftest -m gpu tests/test_torch_binning_kernel.py).
"""

import ctypes
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dtrenderer_tpu_torch.models import edge_cases as ec
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.ops import binning as pbin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(seed, n, h, w, p_valid=0.9, big=0.3):
    """Random bboxes in frame pixels, some beyond the frame and some wide,
    and a random valid mask (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(-20, w + 20, n)
    y0 = rng.integers(-20, h + 20, n)
    x1 = x0 + rng.integers(0, w // 2 + 1, n) * (rng.random(n) < big) \
        + rng.integers(0, 9, n)
    y1 = y0 + rng.integers(0, h // 2 + 1, n) * (rng.random(n) < big) \
        + rng.integers(0, 9, n)
    bbox = torch.tensor(np.stack([x0, y0, x1, y1], 1).astype(np.int32))
    return torch.zeros((n, 16)), bbox, torch.tensor(rng.random(n) < p_valid)


def assert_same_bins(got, want, tag=""):
    for name in ("tile_start", "tri_ids", "overflow"):
        g, r = getattr(got, name), getattr(want, name)
        assert g.dtype == r.dtype == torch.int32, (tag, name)
        assert g.shape == r.shape, (tag, name, g.shape, r.shape)
        assert torch.equal(g.cpu(), r.cpu()), (
            f"{tag}: {name} differs at {int((g.cpu() != r.cpu()).sum())} "
            f"elements")
    assert (got.tile_h, got.tile_w) == (want.tile_h, want.tile_w), tag


# ------------------------------------------------------------- the wrapper


def test_bin_triangles_on_the_cpu_is_the_plain_path():
    coef, bbox, valid = _soup(3, 300, 64, 96)
    before = pbin.KERNEL_LAUNCHES
    for args in ((64, 96, 0, 0, 16, 16, 1), (64, 96, 8, 24, 16, 16, 4)):
        assert_same_bins(pbin.bin_triangles(coef, bbox, valid, *args),
                         pbin.bin_triangles_plain(coef, bbox, valid, *args))
    assert pbin.KERNEL_LAUNCHES == before


def test_the_wrapper_raises_on_other_devices_with_no_fallback():
    coef, bbox, valid = (t.to("meta") for t in _soup(3, 10, 32, 32))
    with pytest.raises(NotImplementedError, match="CUDA .* or CPU"):
        pbin.bin_triangles(coef, bbox, valid, 32, 32)


class _Unused:
    """Kernels that must not be reached."""

    def __getattr__(self, name):
        raise AssertionError(f"launched {name} on bad inputs")


def _bad_inputs(name):
    _, bbox, valid = _soup(5, 10, 32, 32)
    flat = torch.cat([bbox.reshape(-1), bbox.reshape(-1)[:4]])
    return {
        "i64 bbox": (bbox.long(), valid, "bbox must be i32"),
        "3 columns": (bbox[:, :3], valid, "bbox must be i32"),
        "i32 valid": (bbox, valid.int(), "valid bool"),
        "short valid": (bbox, valid[:-1], "valid bool"),
        "misaligned bbox": (flat[1:41].reshape(10, 4), valid, "16-byte"),
    }[name]


@pytest.mark.parametrize("name", ["i64 bbox", "3 columns", "i32 valid",
                                  "short valid", "misaligned bbox"])
def test_bin_on_card_raises_on_inputs_the_kernels_do_not_read(name):
    bbox, valid, match = _bad_inputs(name)
    with pytest.raises(ValueError, match=match):
        pbin.bin_on_card(bbox, valid, 32, 32, 0, 0, 16, 16, 1, _Unused())
    _, bbox, valid = _soup(5, 10, 30, 32)
    with pytest.raises(ValueError, match="must divide"):
        pbin.bin_on_card(bbox, valid, 30, 32, 0, 0, 16, 16, 4, _Unused())


def test_the_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import dtrenderer_tpu_torch.kernels.binning\n"
        "import dtrenderer_tpu_torch.ops.binning\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'dtrenderer_tpu' or m.startswith('dtrenderer_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for rel in ("dtrenderer_tpu_torch/kernels/binning.py",
                "dtrenderer_tpu_torch/ops/binning.py"):
        with open(os.path.join(REPO, rel)) as f:
            assert "jax" not in f.read(), rel


# ------------------------------------------- the kernel source on the host

# What nvcc gives the kernels and g++ does not: CUDA's vector types, the
# launch's indices (one OS thread per CUDA thread of a block), shared
# memory (a static array: the blocks of a grid run one after another),
# __syncthreads (one barrier for the block's threads), __threadfence and
# atomicAdd.
HOST_SHIM = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx;
static thread_local dim3 threadIdx;
static std::barrier<>* host_block_barrier;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <typename T>
inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
// The blocks of a grid one after another, last blockIdx first (the scan's
// slots come from its ticket, not from blockIdx), each with its threads
// started together and one barrier for their __syncthreads.
template <typename F>
static void host_blocks(int64_t blocks, F body) {
  for (int64_t b = blocks - 1; b >= 0; --b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::barrier<> barrier(kThreads);
    host_block_barrier = &barrier;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < kThreads; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        body();
      });
    for (auto& th : threads) th.join();
  }
}

extern "C" int host_bin_budget() { return kBudget; }

extern "C" void host_bin_scan(const int* bbox, const bool* valid,
                              int64_t n_tris, int height, int width,
                              int y_offset, int x_offset, int tile_h,
                              int tile_w, int row_bands, int64_t* work) {
  if (n_tris <= 0) return;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const int64_t blocks = (n_tris + kBudget - 1) / kBudget;
  int64_t* status = work + n_tris + 1;
  std::memset(status, 0, (blocks + 1) * sizeof(int64_t));
  host_blocks(blocks, [=] {
    bin_scan_kernel(reinterpret_cast<const int4*>(bbox), valid, n_tris, g,
                    work, work + n_tris,
                    reinterpret_cast<unsigned long long*>(status),
                    reinterpret_cast<unsigned*>(status + blocks));
  });
}

// No CUB scratch: the host sort needs none.
extern "C" size_t host_bin_scratch_bytes(int64_t n_pairs) {
  return 3 * align256(n_pairs * sizeof(int));
}

// dtr_bin_emit, with CUB's contract for the sort: a stable sort of (key,
// value) on the keys' bits [0, end_bit), keys read as unsigned.
extern "C" void host_bin_emit(const int* bbox, const bool* valid,
                              const int64_t* work, int64_t n_tris,
                              int64_t n_pairs, int height, int width,
                              int y_offset, int x_offset, int tile_h,
                              int tile_w, int row_bands, void* scratch,
                              size_t scratch_bytes, int* tile_start,
                              int* tri_ids) {
  if (n_pairs <= 0) return;
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  const size_t array = align256(n_pairs * sizeof(int));
  char* at = static_cast<char*>(scratch) + (scratch_bytes - 3 * array);
  unsigned* tile_of = reinterpret_cast<unsigned*>(at);
  int* tri_of = reinterpret_cast<int*>(at + array);
  unsigned* keys = reinterpret_cast<unsigned*>(at + 2 * array);
  host_blocks((n_tris + n_pairs + kBudget - 1) / kBudget, [=] {
    bin_emit_kernel(reinterpret_cast<const int4*>(bbox), valid, work, n_tris,
                    n_pairs, g, tile_of, tri_of);
  });
  const int bits = end_bit(g);
  const unsigned mask = bits >= 32 ? ~0u : (1u << bits) - 1u;
  std::vector<int64_t> order(n_pairs);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (tile_of[a] & mask) < (tile_of[b] & mask);
  });
  for (int64_t i = 0; i < n_pairs; ++i) {
    keys[i] = tile_of[order[i]];
    tri_ids[i] = tri_of[order[i]];
  }
  host_blocks((n_pairs + kThreads - 1) / kThreads, [=] {
    bin_starts_kernel(keys, n_pairs, g.n_tiles, tile_start);
  });
}

// The emit's merge-path search alone: one block per two diagonals.
extern "C" void host_merge_splits(const int64_t* ends, int64_t n_tris,
                                  int64_t n_pairs, const int64_t* diagonals,
                                  int64_t n, int64_t* splits) {
  for (int64_t q = 0; q + 1 < n; q += 2)
    host_blocks(1, [=] {
      merge_splits(ends, n_tris, n_pairs, diagonals[q], diagonals[q + 1],
                   splits + q);
    });
}

// The scan's look-back alone, by one block, over status words the caller
// set.
extern "C" int64_t host_look_back(const unsigned long long* status,
                                  int64_t slot) {
  int64_t before = 0;
  host_blocks(1, [=, &before] {
    const int64_t sum = look_back(status, slot);
    if (threadIdx.x == 0) before = sum;
  });
  return before;
}
"""


class HostKernels:
    """kernels/binning.py's entries over the host build, for bin_on_card on
    CPU tensors."""

    def __init__(self, dll):
        self.dll = dll
        self.calls = []

    def budget(self):
        return self.dll.host_bin_budget()

    def scan(self, bbox, valid, grid, work):
        self.calls.append("scan")
        self.dll.host_bin_scan(bbox.data_ptr(), valid.data_ptr(),
                               bbox.shape[0], *grid, work.data_ptr())

    def scratch_bytes(self, n_pairs, grid):
        return self.dll.host_bin_scratch_bytes(n_pairs)

    def emit(self, bbox, valid, work, n_pairs, grid, scratch, tile_start,
             tri_ids):
        self.calls.append("emit")
        self.dll.host_bin_emit(bbox.data_ptr(), valid.data_ptr(),
                               work.data_ptr(), bbox.shape[0], n_pairs,
                               *grid, scratch.data_ptr(), scratch.numel(),
                               tile_start.data_ptr(), tri_ids.data_ptr())


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/binning.cu built for the host: its device code with HOST_SHIM in
    place of the CUDA runtime, HOST_LAUNCH in place of the launches and of
    CUB."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(os.path.join(REPO, "dtrenderer_tpu_torch", "csrc",
                           "binning.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", HOST_SHIM)
    src = src.replace("#include <cub/device/device_radix_sort.cuh>", "")
    src = src[:src.index('extern "C"')]
    out = tmp_path_factory.mktemp("binning_host")
    cpp, lib = out / "binning_host.cpp", out / "binning_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o",
         str(lib), str(cpp)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    size = ctypes.c_size_t
    dll.host_bin_scan.argtypes = [p, p, ll, i, i, i, i, i, i, i, p]
    dll.host_bin_scratch_bytes.argtypes = [ll]
    dll.host_bin_scratch_bytes.restype = size
    dll.host_bin_emit.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p,
                                  size, p, p]
    dll.host_look_back.argtypes = [p, ll]
    dll.host_merge_splits.argtypes = [p, ll, ll, p, ll, p]
    dll.host_look_back.restype = ll
    return dll


def _host_vs_plain(dll, coef, bbox, valid, *grid, tag=""):
    """bin_on_card over the host build against bin_triangles_plain; returns
    the plain Bins and the host kernels' calls."""
    k = HostKernels(dll)
    got = pbin.bin_on_card(bbox, valid, *grid, k)
    want = pbin.bin_triangles_plain(coef, bbox, valid, *grid)
    assert_same_bins(got, want, tag)
    return want, k.calls


SHARDS = [  # (height, width, y_offset, x_offset, tile_h, tile_w, row_bands)
    (128, 256, 0, 0, 16, 16, 1),
    (128, 256, 0, 0, 32, 128, 1),
    (72, 128, 40, 96, 32, 128, 1),     # a shard at an offset
    (128, 128, 0, 128, 16, 16, 1),
    (128, 256, 0, 0, 8, 32, 1),
    (128, 96, 0, 0, 16, 16, 8),        # bands of one tile row
    (136, 96, 0, 0, 16, 16, 8),        # 17 rows: a full and a 1-row tile row
    (90, 50, 0, 0, 16, 16, 3),         # 30 rows, ragged width
    (96, 64, 40, 16, 16, 16, 4),       # banded, at an offset
    (2160, 40, 0, 0, 16, 16, 8),       # 8 bands of 270 rows, 17 tile rows
    (48, 70, 13, 21, 5, 3, 2),         # odd tiles
]


@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: "x".join(map(str, s)))
def test_the_kernel_source_on_the_host_equals_the_plain_path(host_kernels,
                                                             shard):
    h, w, y0, x0 = shard[:4]
    coef, bbox, valid = _soup(h * 7 + w + y0, 400, h + y0 + 20, w + x0 + 20)
    want, calls = _host_vs_plain(host_kernels, coef, bbox, valid, *shard)
    assert calls == ["scan", "emit"]
    assert want.tri_ids.shape[0] > 0


def test_the_kernel_source_on_the_host_on_empty_and_offscreen_scenes(
        host_kernels):
    coef = torch.zeros((5, 16))
    bbox = torch.tensor([[0, 0, 10, 10]] * 5, dtype=torch.int32)
    for valid in (torch.zeros(5, dtype=torch.bool),
                  torch.ones(5, dtype=torch.bool)):
        # second case: the whole scene lies left of a shard at x >= 64
        want, calls = _host_vs_plain(host_kernels, coef, bbox, valid, 32, 32,
                                     0, 64, 16, 16, 1)
        assert want.tri_ids.shape == (0,) and calls == ["scan"]
        assert want.tile_start.tolist() == [0] * 5
    want, _ = _host_vs_plain(host_kernels, coef, bbox,
                             torch.ones(5, dtype=torch.bool), 32, 32, 0, 0,
                             16, 16, 1)
    assert want.tile_start.tolist() == [0, 5, 5, 5, 5]
    # no triangle at all: nothing launched, nothing read
    want, calls = _host_vs_plain(host_kernels, coef[:0], bbox[:0],
                                 torch.ones(0, dtype=torch.bool), 32, 32, 0,
                                 0, 16, 16, 1)
    assert calls == [] and want.tile_start.tolist() == [0] * 5


@pytest.mark.parametrize("what", ["full screen", "one triangle",
                                  "full screen among small ones"])
def test_the_kernel_source_on_the_host_on_single_and_full_screen(
        host_kernels, what):
    h, w = 1080, 1920
    full = torch.tensor([[-5, -3, w + 40, h + 9]], dtype=torch.int32)
    if what == "one triangle":
        bbox = torch.tensor([[500, 300, 530, 333]], dtype=torch.int32)
    elif what == "full screen":
        bbox = full
    else:
        _, small, _ = _soup(11, 60, h, w, big=0.0)
        bbox = torch.cat([small[:30], full, small[30:]])
    coef = torch.zeros((bbox.shape[0], 16))
    valid = torch.ones(bbox.shape[0], dtype=torch.bool)
    want, _ = _host_vs_plain(host_kernels, coef, bbox, valid, h, w, 0, 0, 16,
                             16, 1)
    if what != "one triangle":
        assert want.tri_ids.shape[0] >= 68 * 120  # 8,160 tiles at 1080p
    else:
        assert want.tri_ids.tolist() == [0] * 9


@pytest.mark.parametrize("name", sorted(stress.CASES))
def test_the_kernel_source_on_the_host_on_the_stress_shapes(host_kernels,
                                                            name):
    corners, h, w = stress.CASES[name]()
    setup = stress.setup(corners, h, w, CPU)
    deepest = 0
    for y0, x0, bh, bw in stress.windows(h, w):
        want, _ = _host_vs_plain(host_kernels, setup.coef, setup.bbox,
                                 setup.valid, bh, bw, y0, x0, 16, 16, 1,
                                 tag=f"{name} window {(y0, x0, bh, bw)}")
        deepest = max(deepest, int((want.tile_start[1:]
                                    - want.tile_start[:-1]).max()))
    if name == "deep_tile":
        assert deepest > 512  # the 686-deep pile


@pytest.mark.parametrize("name", ["huge_vertices", "nonfinite_uvs"])
def test_the_kernel_source_on_the_host_on_the_edge_cases(host_kernels, name):
    c = ec.CASES[name]()
    batch, _, _ = ec.pack(c, CPU)
    want, _ = _host_vs_plain(host_kernels, batch.coef, batch.bbox,
                             batch.valid, c.height, c.width, 0, 0, 16, 16, 1,
                             tag=name)
    assert want.tri_ids.shape[0] > 0


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_the_kernel_source_on_the_host_on_random_bboxes(host_kernels, data):
    """Any shard, band count and tile; bboxes anywhere in frame
    coordinates (valid rows have x0 <= x1 and y0 <= y1, as setup makes
    them; invalid rows anything)."""
    n_bands = data.draw(st.integers(1, 4))
    h = n_bands * data.draw(st.integers(1, 40))
    w = data.draw(st.integers(1, 70))
    th, tw = data.draw(st.sampled_from([(16, 16), (8, 32), (5, 3), (4, 4)]))
    y_off, x_off = data.draw(st.integers(0, 30)), data.draw(st.integers(0, 30))
    boxes = data.draw(st.lists(st.tuples(
        st.integers(-40, w + x_off + 40), st.integers(-40, h + y_off + 40),
        st.integers(0, 80), st.integers(0, 80), st.booleans()),
        max_size=25))
    bbox = torch.tensor([[x, y, x + dx, y + dy] if ok else [x + dx, y, x, y]
                         for x, y, dx, dy, ok in boxes],
                        dtype=torch.int32).reshape(-1, 4)
    valid = torch.tensor([ok for *_, ok in boxes], dtype=torch.bool)
    _host_vs_plain(host_kernels, torch.zeros((len(boxes), 16)), bbox, valid,
                   h, w, y_off, x_off, th, tw, n_bands)


def _items(bbox, valid, grid):
    """The merged sequence the emit cuts into blocks, from the plain path:
    per triangle its pairs, then its end; (is_pair, triangle) per item."""
    _, tri = pbin._emit_pairs(bbox, valid, *grid)
    counts = np.bincount(tri.numpy(), minlength=bbox.shape[0])
    items = []
    for t, n in enumerate(counts):
        items += [(True, t)] * int(n) + [(False, t)]
    return items, counts


def _one_tile_each(n, per_row):
    """n triangles, one 16 x 16 tile each, row-major over per_row tile
    columns."""
    k = np.arange(n)
    x, y = (k % per_row) * 16 + 3, (k // per_row) * 16 + 3
    return torch.tensor(np.stack([x, y, x + 2, y + 2], 1).astype(np.int32))


def _budget_case(name, budget):
    """(bbox, valid, grid) of one edge of the blocks' budgets."""
    ones = lambda n: torch.ones(n, dtype=torch.bool)  # noqa: E731
    if name == "budget starts mid-triangle":
        _, bbox, valid = _soup(21, 3000, 1080, 1920, big=0.2)
        return bbox, valid, (1080, 1920, 0, 0, 16, 16, 1)
    if name == "one triangle over several blocks":
        _, small, _ = _soup(12, 40, 1080, 1920, big=0.0)
        full = torch.tensor([[0, 0, 1919, 1079]], dtype=torch.int32)
        bbox = torch.cat([small[:20], full, small[20:]])
        return bbox, ones(41), (1080, 1920, 0, 0, 16, 16, 1)
    if name == "zero-cover run longer than a budget":
        _, bbox, _ = _soup(13, 2 * budget + 700, 256, 256, big=0.1)
        valid = ones(bbox.shape[0])
        valid[3:3 + 2 * budget + 300] = False
        return bbox, valid, (256, 256, 0, 0, 16, 16, 1)
    if name == "P = budget, one triangle":
        # 64 x 64 tiles; the bbox spans budget / 64 tile rows of 64
        n_rows = budget // 64
        bbox = torch.tensor([[0, 0, 1023, n_rows * 16 - 1]], dtype=torch.int32)
        return bbox, ones(1), (1024, 1024, 0, 0, 16, 16, 1)
    if name == "P = 2 budgets = T":
        return (_one_tile_each(2 * budget, 64), ones(2 * budget),
                (2 * budget // 64 * 16, 1024, 0, 0, 16, 16, 1))
    if name == "T + P = budget":
        return (_one_tile_each(budget // 2, 64), ones(budget // 2),
                (1024, 1024, 0, 0, 16, 16, 1))
    if name == "look-back over three blocks":
        _, bbox, valid = _soup(14, 3 * budget + 5, 300, 400, big=0.05)
        return bbox, valid, (300, 400, 0, 0, 16, 16, 1)
    raise KeyError(name)


BUDGET_CASES = ["budget starts mid-triangle",
                "one triangle over several blocks",
                "zero-cover run longer than a budget",
                "P = budget, one triangle", "P = 2 budgets = T",
                "T + P = budget", "look-back over three blocks"]


@pytest.mark.parametrize("name", BUDGET_CASES)
def test_the_kernel_source_on_the_host_at_the_block_budgets(host_kernels,
                                                             name):
    """Each case first shows that it reaches its edge of the scan's and the
    emit's blocks of `budget` items, then holds the host build to the
    plain path."""
    budget = host_kernels.host_bin_budget()
    bbox, valid, grid = _budget_case(name, budget)
    items, counts = _items(bbox, valid, grid)
    T, P = len(counts), int(counts.sum())
    cuts = range(budget, len(items), budget)
    blocks = [items[d:d + budget] for d in range(0, len(items), budget)]
    if name == "budget starts mid-triangle":
        assert any(items[d - 1][0] and items[d][0]
                   and items[d - 1][1] == items[d][1] for d in cuts)
    elif name == "one triangle over several blocks":
        spread = max(sum(any(it == (True, t) for it in blk) for blk in blocks)
                     for t in np.flatnonzero(counts == counts.max()))
        assert spread >= 3
    elif name == "zero-cover run longer than a budget":
        assert any(not any(is_pair for is_pair, _ in blk) for blk in blocks)
    elif name == "P = budget, one triangle":
        assert (T, P) == (1, budget)
    elif name == "P = 2 budgets = T":
        assert T == P == 2 * budget and (T + P) % budget == 0
    elif name == "T + P = budget":
        assert T + P == budget
    else:
        assert -(-T // budget) >= 3  # scan blocks
    want, calls = _host_vs_plain(host_kernels, torch.zeros((T, 16)), bbox,
                                 valid, *grid, tag=name)
    assert calls == ["scan", "emit"] and want.tri_ids.shape[0] == P


def test_the_look_back_reads_aggregates_until_a_prefix(host_kernels):
    """The scan's look-back over status words as blocks in flight leave
    them: slot 4 adds the aggregates of slots 3 and 2 and stops at slot 1's
    prefix (slot 0's is read, not added); slot 300 adds 299 aggregates over
    two windows of the block's words down to slot 0's prefix."""
    agg, pre = 1 << 62, 2 << 62
    status = (ctypes.c_ulonglong * 301)(agg | 1000, pre | 12, agg | 3,
                                        agg | 4, agg | 5)
    addr = ctypes.addressof(status)
    assert host_kernels.host_look_back(addr, 0) == 0
    assert host_kernels.host_look_back(addr, 4) == 12 + 3 + 4
    assert host_kernels.host_look_back(addr, 5) == 12 + 3 + 4 + 5
    status[0] = pre | 7
    for i in range(1, 300):
        status[i] = agg | 1
    assert host_kernels.host_look_back(addr, 300) == 7 + 299
    assert host_kernels.host_look_back(addr, 1) == 7


def test_the_merge_path_search_equals_a_plain_search(host_kernels):
    """The emit's block-wide search of its diagonals against the merge path
    itself (triangle t's end is item t + ends[t]: the triangles among the
    first d items are the ends before d), on ends with long zero-cover runs
    and wide triangles; among the diagonals, those whose answer lies just
    past the last probe of the first round (a range of over 128 * 127
    triangles, behind a triangle of more pairs than that)."""
    rng = np.random.default_rng(17)
    n = 20000
    counts = rng.integers(0, 6, n) * (rng.random(n) < 0.6)
    counts[500:1400] = 0
    counts[2000] = 900
    counts[-1] = 25000  # diagonals near P then search ranges of ~T
    ends = np.cumsum(counts).astype(np.int64)
    T, P = n, int(ends[-1])
    d = np.arange(T + P + 1)
    want = np.searchsorted(np.arange(T) + ends, d, side="left")
    probes = 128  # kThreads / 2
    lo, hi = np.maximum(0, d - P), np.minimum(d, T)
    step = -(-(hi - lo) // probes)
    edge = np.flatnonzero((hi - lo > probes)
                          & (want == lo + (probes - 1) * step + 1))
    assert edge.size, "no diagonal reaches the search's last probe"
    diagonals = np.unique(np.concatenate([
        edge[:40], rng.integers(0, T + P + 1, 58), [0, T + P]]))
    diagonals = diagonals[:len(diagonals) // 2 * 2].astype(np.int64)
    splits = np.zeros_like(diagonals)
    host_kernels.host_merge_splits(ends.ctypes.data, T, P,
                                   diagonals.ctypes.data, len(diagonals),
                                   splits.ctypes.data)
    assert splits.tolist() == want[diagonals].tolist()


INVERTED = torch.tensor([[100, 0, 0, 50], [100, 100, 0, 0]], dtype=torch.int32)


def test_the_plain_path_bins_an_inverted_bbox_as_empty():
    """A valid row whose span is not positive bins nothing: alone, among
    other triangles, over bands and in the distributed binning."""
    ok = torch.tensor([[10, 20, 40, 70]], dtype=torch.int32)
    for bands in (1, 4):
        grid = (128, 128, 0, 0, 16, 16, bands)
        alone = pbin.bin_triangles_plain(torch.zeros((2, 16)), INVERTED,
                                         torch.ones(2, dtype=torch.bool),
                                         *grid)
        assert alone.tri_ids.shape == (0,)
        assert not alone.tile_start.any()
        bbox = torch.cat([INVERTED[:1], ok, INVERTED[1:]])
        mixed = pbin.bin_triangles_plain(torch.zeros((3, 16)), bbox,
                                         torch.ones(3, dtype=torch.bool),
                                         *grid)
        only = pbin.bin_triangles_plain(torch.zeros((1, 16)), ok,
                                        torch.ones(1, dtype=torch.bool),
                                        *grid)
        assert torch.equal(mixed.tile_start, only.tile_start)
        assert set(mixed.tri_ids.tolist()) == {1}
    valid = torch.ones(3, dtype=torch.bool)
    bands = pbin.bin_triangles_distributed([bbox] * 4, [valid] * 4, 128, 128,
                                           4)
    assert {i for b in bands for i in pbin.window_ids(b).tolist()} == {1}


@pytest.mark.parametrize("where", ["alone", "in a soup"])
def test_the_kernel_source_on_the_host_on_inverted_bboxes(host_kernels,
                                                          where):
    if where == "alone":
        bbox = INVERTED
    else:
        _, soup, _ = _soup(15, 200, 128, 128)
        bbox = torch.cat([soup[:50], INVERTED, soup[50:]])
        flip = torch.from_numpy(np.random.default_rng(15).random(bbox.shape[0])
                                < 0.2)
        bbox[flip] = bbox[flip][:, [2, 3, 0, 1]]  # x1, y1 before x0, y0
    valid = torch.ones(bbox.shape[0], dtype=torch.bool)
    for bands in (1, 4):
        _host_vs_plain(host_kernels, torch.zeros((bbox.shape[0], 16)), bbox,
                       valid, 128, 128, 0, 0, 16, 16, bands, tag=where)


# --------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _card_vs_plain(coef, bbox, valid, *grid):
    dev = _card()
    before = pbin.KERNEL_LAUNCHES
    got = pbin.bin_triangles(coef.to(dev), bbox.to(dev), valid.to(dev),
                             *grid)
    assert pbin.KERNEL_LAUNCHES == before + (1 if bbox.shape[0] else 0)
    assert got.tile_start.device == dev and got.tri_ids.device == dev
    assert_same_bins(got, pbin.bin_triangles_plain(coef, bbox, valid, *grid))


@pytest.mark.gpu
@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: "x".join(map(str, s)))
def test_the_kernel_equals_its_twin_on_random_soups(shard):
    h, w, y0, x0 = shard[:4]
    _card_vs_plain(*_soup(h * 7 + w + y0, 20000, h + y0 + 20, w + x0 + 20),
                   *shard)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(stress.CASES))
def test_the_kernel_equals_its_twin_on_the_stress_shapes(name):
    corners, h, w = stress.CASES[name]()
    setup = stress.setup(corners, h, w, CPU)
    for y0, x0, bh, bw in stress.windows(h, w):
        _card_vs_plain(setup.coef, setup.bbox, setup.valid, bh, bw, y0, x0,
                       16, 16, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ec.CASES))
def test_the_kernel_equals_its_twin_on_the_edge_cases(name):
    c = ec.CASES[name]()
    batch, _, _ = ec.pack(c, CPU)
    _card_vs_plain(batch.coef, batch.bbox, batch.valid, c.height, c.width, 0,
                   0, 16, 16, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", BUDGET_CASES)
def test_the_kernel_equals_its_twin_at_the_block_budgets(name):
    _card()
    from dtrenderer_tpu_torch.kernels import binning as kb

    bbox, valid, grid = _budget_case(name, kb.budget())
    _card_vs_plain(torch.zeros((bbox.shape[0], 16)), bbox, valid, *grid)


@pytest.mark.gpu
def test_the_kernel_bins_an_inverted_bbox_as_its_twin_does():
    _, soup, _ = _soup(15, 5000, 1080, 1920)
    bbox = torch.cat([soup[:50], INVERTED, soup[50:]])
    flip = torch.from_numpy(np.random.default_rng(16).random(bbox.shape[0])
                            < 0.2)
    bbox[flip] = bbox[flip][:, [2, 3, 0, 1]]
    valid = torch.ones(bbox.shape[0], dtype=torch.bool)
    for bands in (1, 8):
        _card_vs_plain(torch.zeros((bbox.shape[0], 16)), bbox, valid, 1080,
                       1920, 0, 0, 16, 16, bands)


def _syncs(fn):
    """Host synchronisations fn() makes, counted under torch's sync debug
    mode."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


@pytest.mark.gpu
def test_one_host_synchronise_a_call_where_the_plain_path_has_more():
    dev = _card()
    coef, bbox, valid = (t.to(dev) for t in _soup(7, 50000, 1080, 1920))
    args = (coef, bbox, valid, 1080, 1920, 0, 0, 16, 16, 1)
    pbin.bin_triangles(*args)  # build and load first
    assert _syncs(lambda: pbin.bin_triangles(*args)) == 1
    assert _syncs(lambda: pbin.bin_triangles_plain(*args)) > 1

"""The binning kernels (csrc/binning.cu) and their host side in
ops/binning.py.

Bars:
  * `bin_triangles` on a CPU tensor is `bin_triangles_plain` and launches
    nothing; on a device that is neither CPU nor CUDA it raises, and
    `bin_on_card` raises on inputs the kernels do not read: no fallback;
  * csrc/binning.cu itself, compiled for the host with g++ and a few shims
    (one OS thread per CUDA thread of a block, atomics for the tile counts,
    and a stable sort on the key's low bits in place of CUB's radix sort),
    driven by `bin_on_card` exactly as on the card, gives the Bins of
    `bin_triangles_plain` bit for bit (tile_start, tri_ids, overflow) on:
    random soups over shards at offsets and several tiles, the banded grids
    of tests/test_torch_binning.py (270-row bands of 17 tile rows among
    them), empty and off-screen scenes, the shapes of models/stress.py (the
    686-deep pile and the edge grids, whole and in windows), the
    `huge_vertices` and `nonfinite_uvs` cases of models/edge_cases.py, a
    full-screen triangle, no pair at all, one triangle, and random bboxes
    (hypothesis). Checked without a card (skipped where there is no g++);
  * nothing of the new modules imports JAX or the JAX package;
  * on the card (`gpu`): the kernel against its twin on random soups, the
    stress shapes and the edge cases, one host synchronise a call where
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

# What nvcc gives the kernels and g++ does not: CUDA's int4, the launch's
# indices (one OS thread per CUDA thread of a block) and atomicAdd.
HOST_SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <numeric>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct int4 { int x, y, z, w; };
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx;
static thread_local dim3 threadIdx;
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
using std::min; using std::max;
typedef int cudaError_t;
"""

HOST_LAUNCH = r"""
// A block's threads start together (a barrier), so that their atomic
// adds into one tile's count meet as they do on the card.
template <typename F>
static void host_grid(int64_t n, F body) {
  for (int64_t b = 0; b * kThreads < n; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::barrier<> start(kThreads);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < kThreads; ++t)
      threads.emplace_back([=, &start] {
        threadIdx.x = t;
        start.arrive_and_wait();
        body();
      });
    for (auto& th : threads) th.join();
  }
}

extern "C" void host_bin_cover(const int* bbox, const bool* valid,
                               int64_t n_tris, int height, int width,
                               int y_offset, int x_offset, int tile_h,
                               int tile_w, int row_bands, int64_t* n_cover) {
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  host_grid(n_tris, [=] {
    bin_cover_kernel(reinterpret_cast<const int4*>(bbox), valid, n_tris, g,
                     n_cover);
  });
}

extern "C" void host_bin_pairs(const int* bbox, const bool* valid,
                               const int64_t* ends, int64_t n_tris,
                               int64_t n_pairs, int height, int width,
                               int y_offset, int x_offset, int tile_h,
                               int tile_w, int row_bands, int* tile_of,
                               int* tri_of, int* counts) {
  const Grid g = make_grid(height, width, y_offset, x_offset, tile_h, tile_w,
                           row_bands);
  host_grid(n_pairs, [=] {
    bin_pairs_kernel(reinterpret_cast<const int4*>(bbox), valid, ends,
                     n_tris, n_pairs, g,
                     reinterpret_cast<unsigned*>(tile_of), tri_of, counts);
  });
}

// CUB's contract: a stable sort of (key, value) on the keys' bits
// [0, end_bit), keys read as unsigned.
extern "C" void host_bin_sort(const int* keys_in, int* keys_out,
                              const int* values_in, int* values_out, int n,
                              int end_bit) {
  const unsigned mask = end_bit >= 32 ? ~0u : (1u << end_bit) - 1u;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return (static_cast<unsigned>(keys_in[a]) & mask) <
           (static_cast<unsigned>(keys_in[b]) & mask);
  });
  for (int i = 0; i < n; ++i) {
    keys_out[i] = keys_in[order[i]];
    values_out[i] = values_in[order[i]];
  }
}
"""


class HostKernels:
    """kernels/binning.py's three entries over the host build, for
    bin_on_card on CPU tensors."""

    def __init__(self, dll):
        self.dll = dll
        self.calls = []

    def cover(self, bbox, valid, grid, n_cover):
        self.calls.append("cover")
        self.dll.host_bin_cover(bbox.data_ptr(), valid.data_ptr(),
                                bbox.shape[0], *grid, n_cover.data_ptr())

    def pairs(self, bbox, valid, ends, grid, tile_of, tri_of, counts):
        self.calls.append("pairs")
        self.dll.host_bin_pairs(bbox.data_ptr(), valid.data_ptr(),
                                ends.data_ptr(), bbox.shape[0],
                                tile_of.shape[0], *grid, tile_of.data_ptr(),
                                tri_of.data_ptr(), counts.data_ptr())

    def sort_pairs(self, keys, values, keys_out, values_out, end_bit):
        self.calls.append("sort")
        self.dll.host_bin_sort(keys.data_ptr(), keys_out.data_ptr(),
                               values.data_ptr(), values_out.data_ptr(),
                               keys.shape[0], end_bit)


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
    src = src[:src.index('extern "C" cudaError_t dtr_bin_cover(')]
    out = tmp_path_factory.mktemp("binning_host")
    cpp, lib = out / "binning_host.cpp", out / "binning_host.so"
    cpp.write_text(src + HOST_LAUNCH)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o",
         str(lib), str(cpp)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.host_bin_cover.argtypes = [p, p, ll, i, i, i, i, i, i, i, p]
    dll.host_bin_pairs.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p,
                                   p, p]
    dll.host_bin_sort.argtypes = [p, p, p, p, i, i]
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
    assert calls == ["cover", "pairs", "sort"]
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
        assert want.tri_ids.shape == (0,) and calls == ["cover"]
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

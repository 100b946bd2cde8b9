"""Suite-wide pytest settings: deal the heavy cases across xdist workers, and
keep a long-lived test process under the kernel's limit on memory mappings.

Collection order. Under `-n 6 --dist load` pytest-xdist hands each worker
runs of consecutive cases (first `len(items) // 6 // 4`, then 29-58 at a
time). In file order the cases of 20 s or more bunch together, mostly in
tests/test_render_fused.py and tests/test_shard.py, so one worker drew most
of them: the run took 1,334 s at commit 88f1b7b, and a replay of its junit
times puts 1,303 s on that worker and 371-433 s on each of the other five.
`spread_heavy` places the cases of HEAVY_CASES at even strides through the
first 80% of the order and keeps every other case in its collected order, so
a file's light cases still share a worker's compile caches.
`python tests/xdist_replay.py` is that replay.

Memory mappings. XLA:CPU maps fresh memory for every program it compiles
and keeps it mapped while the executable is cached: a small jitted function
costs about 15 mappings, one of the heavier raster tests about 8,500
(counted in /proc/self/maps). Linux refuses an `mmap` once a process holds
`vm.max_map_count` mappings (65,530 by default), and the next large compile
then dies inside LLVM with a segmentation fault or an abort. How many heavy
tests one pytest-xdist worker runs in a row depends on the size of the suite,
so a cache clear on a fixed count of tests cannot promise to come in time.
This fixture looks at the process itself: once a test leaves it holding more
than a quarter of the limit, JAX's caches are dropped, which unmaps the
compiled programs. Tests that never touch JAX cost one read of
/proc/self/maps each.
"""

import gc
import sys

import pytest


# The cases that take 20 s or more on one worker, with their seconds in a
# junit run of the suite (`-n 6 --dist load`) at commit 88f1b7b. The seconds
# only order the list; a new case of 20 s or more joins it.
HEAVY_CASES = (
    ("tests/test_render_fused.py::test_fused_flat_bins_image_identical[opts3]", 158.7),
    ("tests/test_shard.py::test_frames_x_rows_mesh", 107.3),
    ("tests/test_render_fused.py::test_fused_slot_k_image_identical[opts2]", 104.8),
    ("tests/test_shard.py::test_row_sharded_matches_single", 95.4),
    ("tests/test_render_fused.py::test_fused_flat_bins_image_identical[opts1]", 93.3),
    ("tests/test_goldens.py::test_goldens_match", 89.8),
    ("tests/test_render_fused.py::test_fused_slot_k_image_identical[opts3]", 79.1),
    ("tests/test_shard.py::test_2d_frames_x_rows_x_cols_mesh", 72.4),
    ("tests/test_render_fused.py::test_fused_slot_k_image_identical[opts0]", 71.2),
    ("tests/test_render_fused.py::test_fused_flat_bins_image_identical[opts0]", 71.2),
    ("tests/test_draw_meshes.py::test_batched_matches_sequential_fused", 69.4),
    ("tests/test_render_fused.py::test_fused_flat_bins_image_identical[opts2]", 66.7),
    ("tests/test_shard.py::test_2d_rows_x_cols_sharded_matches_single", 63.5),
    ("tests/test_render_fused.py::test_fused_slot_k_image_identical[opts1]", 63.4),
    ("tests/test_render_fused.py::test_fused_flat_bins_image_identical[opts4]", 62.2),
    ("tests/test_shard.py::test_shard_budget_compaction_bit_exact", 62.0),
    ("tests/test_render_fused.py::test_fused_broad_plus_small_y_sorted_matches_ref", 41.6),
    ("tests/test_torch_vertex_batch.py::test_config4_rows_against_reference_prepare_draw", 35.6),
    ("tests/test_translucency.py::test_draw_meshes_interleaved_opaque_translucent_opaque", 35.1),
    ("tests/test_render_fused.py::test_fused_pair_budget_image_identical", 32.2),
    ("tests/test_render_fused.py::test_fused_matches_ref_fuzz[0]", 31.6),
    ("tests/test_render_fused.py::test_fused_multi_draw_depth_merge", 30.9),
    ("tests/test_overflow_audit.py::test_overflow_flows_out_of_jitted_production_path", 30.8),
    ("tests/test_render_fused.py::test_fused_matches_ref_sphere_no_texture", 30.6),
    ("tests/test_render_fused.py::test_fused_matches_ref_fuzz[1]", 27.9),
    ("tests/test_draw_meshes.py::test_mixed_sampling_matches_sequential", 27.9),
    ("tests/test_torch_ordered.py::test_draw_meshes_interleaved_matches_reference", 27.0),
    ("tests/test_torch_pipeline.py::test_draw_mesh_config5_matches_reference", 25.6),
    ("tests/test_torch_pipeline.py::test_draw_meshes_config4_matches_reference", 25.0),
    ("tests/test_pipeline.py::test_config3_gouraud_bilinear_sphere", 24.6),
    ("tests/test_overflow_audit.py::test_audit_bands_agrees_with_render_time_overflow[legacy_dense]", 23.5),
    ("tests/test_translucency.py::test_draw_meshes_routes_translucent_specs", 23.2),
    ("tests/test_shard.py::test_shared_crossband_binning_sharded_matches_single", 23.0),
    ("tests/test_api_surface.py::test_full_frame_through_api", 22.2),
    ("tests/test_render_fused.py::test_fused_flat_broad_cap_zero_matches_dense", 21.9),
    ("tests/test_translucency.py::test_overlapping_translucent_tris_one_mesh_match_oracle", 20.9),
    ("tests/test_pipeline.py::test_config2_textured_cube_nearest", 20.9),
    ("tests/test_overflow_audit.py::test_audit_bands_agrees_with_render_time_overflow[shared]", 20.8),
    ("tests/test_translucency.py::test_ordered_translucent_phong_vs_oracle_and_scan", 20.6),
)


def spread_heavy(items):
    """`items` with the collected cases of HEAVY_CASES, heaviest first, at
    even strides through the first 80% of the order and every other case in
    its collected relative order: a permutation that depends on the order of
    `items` and of HEAVY_CASES alone, the same in every worker process."""
    seconds = dict(HEAVY_CASES)
    heavy = sorted((it for it in items if it.nodeid in seconds),
                   key=lambda it: -seconds[it.nodeid])
    if not heavy:
        return list(items)
    light = (it for it in items if it.nodeid not in seconds)
    n, h = len(items), len(heavy)
    # The k-th heaviest at k * max(0.8 n, h) / h, in whole positions.
    span = max(4 * n, 5 * h)
    slots = {k * span // (5 * h): item for k, item in enumerate(heavy)}
    return [slots[i] if i in slots else next(light) for i in range(n)]


@pytest.hookimpl(trylast=True)  # after `-m` and `-k` have deselected
def pytest_collection_modifyitems(items):
    items[:] = spread_heavy(items)


def _map_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


def _n_maps() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # no procfs: nothing to watch
        return 0


_CLEAR_ABOVE = _map_limit() // 4


@pytest.fixture(autouse=True)
def _release_executables_near_map_limit():
    yield
    jax = sys.modules.get("jax")
    if jax is not None and _n_maps() > _CLEAR_ABOVE:
        jax.clear_caches()
        gc.collect()

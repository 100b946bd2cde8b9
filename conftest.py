"""Suite-wide pytest fixture: keep a long-lived test process under the
kernel's limit on memory mappings.

XLA:CPU maps fresh memory for every program it compiles and keeps it mapped
while the executable is cached: a small jitted function costs about 15
mappings, one of the heavier raster tests about 8,500 (counted in
/proc/self/maps). Linux refuses an `mmap` once a process holds
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

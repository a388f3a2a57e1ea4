import os
import sys

import numpy as np
import pytest

# make tests/_hyp.py (hypothesis optional-dependency shim) importable from
# test modules in subdirectories regardless of pytest's import mode
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a hand-written CUDA kernel "
        "has no CPU mode); skips on hosts without one")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


# Every jitted executable the suite compiles stays mmapped in the XLA CPU
# client for the life of the process; the full tier-1 run now compiles
# enough of them to hit the kernel's vm.max_map_count (65530 by default),
# at which point the NEXT backend_compile segfaults inside XLA.  At each
# module boundary, if the process is using a big fraction of the limit,
# drop the jit caches — within-module compile-cache assumptions (e.g. the
# serving engine's warm-process reuse tests) are untouched, and modules
# are independent across that boundary by construction.
_MAPS_FILE = "/proc/self/maps"


def _n_maps():
    try:
        with open(_MAPS_FILE) as f:
            return sum(1 for _ in f)
    except OSError:        # non-Linux: no /proc, and no 65530 cliff either
        return 0


def _max_maps():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


def _clear_jit():
    import gc

    import jax
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def _shed_jit_maps():
    # 0.25: the heaviest single module grows ~33k maps on its own, so the
    # clear must fire while there is still >33k of headroom below the cap
    if _n_maps() > 0.25 * _max_maps():
        _clear_jit()
    yield


def pytest_runtest_teardown(item, nextitem):
    # emergency brake inside a module: better a recompile than a segfault
    if _n_maps() > 0.8 * _max_maps():
        _clear_jit()


def assert_close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)

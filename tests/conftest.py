"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the env vars before the first ``import jax`` anywhere in the test
process — conftest is imported before test modules, so do it here.
"""

import os
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# XLA:CPU runs an FFT on a thread pool whose split of the work varies from
# call to call, and with it the last bits of larger transforms; the
# bit-identity gates between program structures (resident vs streamed vs
# mesh) need the single-threaded, deterministic transform
if "xla_cpu_multi_thread_eigen" not in flags:
    flags += " --xla_cpu_multi_thread_eigen=false"
os.environ["XLA_FLAGS"] = flags.strip()
# point the persistent XLA compile cache at a per-session temp dir so test
# runs never deserialise executables cached by earlier runs/configurations
# (the CLI then sets no cache directory of its own)
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="oiptpu_jax_test_"
)

import faulthandler  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Per-test hang watchdog (pytest-timeout is not in this image).  A hung
# device call blocks the main thread at the C level, where neither pytest
# nor signal handlers can interrupt; faulthandler's watchdog THREAD still
# fires — it dumps every stack and hard-exits, failing CI fast instead of
# stalling it.  Generous default: the 1-core CI host legitimately spends
# minutes in single tests during sporadic slow phases.
_TEST_TIMEOUT = float(os.environ.get("OIP_TEST_TIMEOUT", 900))


@pytest.fixture(autouse=True)
def _hang_watchdog():
    if _TEST_TIMEOUT > 0:
        faulthandler.dump_traceback_later(_TEST_TIMEOUT, exit=True)
    yield
    if _TEST_TIMEOUT > 0:
        faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)

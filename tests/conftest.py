"""Test configuration.

The tests run on the CPU with an 8-device virtual mesh, so the sharding
tests run anywhere.  Tests marked ``gpu`` need the card: they skip here
(tests/test_gpu.py) and run on the GPU inside ``python chip_smoke.py``,
which starts JAX on the card before pytest loads this file — a process
that has already brought up its devices keeps them.
"""

import os
import sys


def _devices_already_up() -> bool:
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge

    return xla_bridge.backends_are_initialized()


if not _devices_already_up():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def snr_db(ref, test):
    """Signal-to-error ratio in dB between a reference and a test signal."""
    ref = np.asarray(ref, dtype=np.complex128)
    test = np.asarray(test, dtype=np.complex128)
    err = ref - test
    p_sig = np.mean(np.abs(ref) ** 2)
    p_err = np.mean(np.abs(err) ** 2)
    if p_err == 0:
        return np.inf
    return 10 * np.log10(p_sig / p_err)

"""Test harness configuration (SURVEY.md §4.4).

Forces the CPU backend with 8 virtual devices BEFORE jax import so sharding
tests exercise real psum/pmin collectives without an accelerator, enables
x64 so golden-parity tests compare against the float64 NumPy oracle at tight
tolerance.  On the CPU the Pallas rollout kernel runs in interpret mode.
float32 precision is tested by passing explicit float32 arrays.

``MPPI_TEST_GPU=1`` leaves the GPU backend on instead (x64 off, kernels
compiled) — that is how ``chip_smoke.py`` runs the ``gpu``-marked tests on
the card, in its own process.
"""

import os
import sys

_GPU = os.environ.get("MPPI_TEST_GPU", "").lower() not in ("", "0", "false",
                                                           "no")
if not _GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _GPU:
    # pin the CPU explicitly (the backend is initialised lazily, so this
    # takes effect as long as it runs before first use)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (tests marked ``gpu``).

    Decided here, at run time, never at import: every xdist worker must
    collect the same tests.
    """
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run on the card with `python chip_smoke.py`")


@pytest.fixture(scope="session")
def ref_path():
    """The reference circle path (xydq_circle.txt, cols 0:4) as float64.

    Source: the copy embedded in the committed golden npz (the exact input
    the golden run was executed with), so the suite is self-contained; the
    synthesised circle is the fallback.
    """
    golden = os.path.join(os.path.dirname(__file__), "data",
                          "reference_golden_run.npz")
    if os.path.exists(golden):
        with np.load(golden) as d:
            if "ref_path" in d:
                return d["ref_path"]
    from mppi_robotarm.sim.paths import synth_circle_path
    return synth_circle_path(2000, dtype=np.float64)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)

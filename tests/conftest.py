import os

# The tests run on the CPU unless JAX_PLATFORMS names another platform:
# multi-device sharding tests use a virtual 8-device CPU mesh (the standard
# JAX host-device-count trick, SURVEY.md §4.4). The env vars alone are not
# enough when a GPU plugin is installed, so the config is forced too, before
# any backend initializes. Tests that need the GPU carry the `gpu` marker
# and run with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` (a phase
# of chip_smoke.py); on the CPU they skip (see the `gpu` fixture).
ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest

try:
    import jax

    if ON_CPU:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
        # Entry points turn on the persistent compile cache; test
        # processes (several xdist workers at once) must not share one.
        jax.config.update("jax_enable_compilation_cache", False)
except ImportError:  # pragma: no cover
    pass


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips where there is none.
    Decided at run time, never at import, so every xdist worker collects
    the same tests."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return gpus[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def ref_lib():
    """Compiled C++ reference decoder, or skip."""
    from tools import ref_shim

    lib = ref_shim.get_lib()
    if lib is None:
        pytest.skip(f"reference shim unavailable: {ref_shim._lib_err}")
    return ref_shim


@pytest.fixture(scope="session")
def ref_example(ref_lib):
    """Compiled reference example CLI binary, or skip."""
    from tools import ref_shim

    exe = ref_shim.build_example()
    if exe is None:
        pytest.skip("reference example binary unavailable")
    return exe


def random_plane(rng, h, w, maxv):
    return rng.integers(0, maxv + 1, size=(h, w), dtype=np.uint16)

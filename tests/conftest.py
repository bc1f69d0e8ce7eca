import os
import sys

# The tests run on the CPU, with a virtual 8-device mesh for the
# multi-device tests; JAX_PLATFORMS=cpu also tells the device modes
# that the CPU is meant (smalt_tpu/device.py).  Tests that need the
# accelerator carry the `gpu` marker and skip on the CPU.
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8 "
                      + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skipped on the CPU and run on the "
        "card by chip_smoke.py")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_the_card(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs the GPU (run on the card by chip_smoke.py)")


@pytest.fixture(scope="session")
def data_dir():
    return DATA


@pytest.fixture(scope="session")
def indexed(tmp_path_factory):
    """Build refset + k13/s4 index over the bundled genome once."""
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu.index.table import build_index

    refset = RefSet.from_fasta(os.path.join(DATA, "genome.fa"))
    idx = build_index(refset, 13, 4)
    return refset, idx

"""Test configuration: JAX on a virtual 8-device CPU mesh.

Sharding correctness is validated on host-platform virtual devices (same
XLA partitioner semantics as a multi-GPU mesh).  The suite runs on the
CPU (JAX_PLATFORMS=cpu unless the caller chose otherwise).  Tests marked
`gpu` take the `gpu` fixture and skip without a card; on a GPU machine
run them with `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`.
Must run before the first `import jax` in any test module.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    # function-scoped: each test draws a reproducible sequence regardless
    # of which other tests ran before it
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu on a GPU machine)")
    return jax.devices()[0]


def random_seq(rng, n: int, with_n: bool = False) -> bytes:
    alphabet = b"ACGTN" if with_n else b"ACGT"
    probs = [0.245, 0.245, 0.245, 0.245, 0.02] if with_n else None
    return rng.choice(list(alphabet), size=n, p=probs).astype(np.uint8).tobytes()


@pytest.fixture
def random_seq_fn():
    return random_seq

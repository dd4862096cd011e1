"""Shared fixtures.  NOTE: device count must stay 1 here (smoke tests /
benches see the real host); multi-device tests live in test_multidevice.py
which re-executes itself in a subprocess with XLA_FLAGS set."""

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_arch
from repro.sharding import single_device_plan


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (from a fixture) without one"
    )


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def tiny_batch(arch, b=2, s=32, key=None):
    key = key if key is not None else jax.random.PRNGKey(7)
    toks = jax.random.randint(key, (b, s), 0, arch.vocab_size)
    batch = {"tokens": toks, "labels": toks}
    if arch.frontend:
        batch["embeds"] = jax.random.normal(
            key, (b, s, arch.d_model), jnp.float32
        )
    return batch

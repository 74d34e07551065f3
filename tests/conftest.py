"""Test configuration: JAX on the CPU with a virtual 8-device mesh.

Multi-device shardings are validated without several accelerators by
forcing the host platform to expose 8 virtual devices (the standard JAX
technique for testing pjit/shard_map topologies).

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them elsewhere. ``python -m pytest -m gpu tests/`` on a
GPU machine runs exactly those, on the GPU; every other selection runs on the
CPU.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402


#: The pre-commit truth chain (CLAUDE.md): one golden + one differential
#: test per engine, plus the cheap serde/config guards. ``pytest -m quick``
#: must stay under ~2 min; the full suite is the gate for engine changes,
#: this is the gate for everything else.
_QUICK = (
    "test_oracle_golden.py::TestPlayOutcome",
    "test_oracle_golden.py::TestShieldwalls::test_regular",
    "test_oracle_golden.py::TestRepetitions::test_repetition_loss",
    "test_env_golden.py::test_shieldwall_step_parity[regular]",
    "test_env_differential.py::test_differential_random_playouts[0-brandubh]",
    "test_step_kernel.py::test_batched_step_matches_oracle[brandubh]",
    "test_native_engine.py::test_native_differential[brandubh]",
    "test_mcts.py::test_mcts_differential[brandubh]",
    "test_mcts.py::test_config_mode_validation",
    "test_fen.py::",
    "test_compat_and_parallel.py::test_env_value_identity",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast pre-commit truth-chain subset (see conftest)"
    )
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.split("tests/")[-1]
        if any(nodeid.startswith(q) for q in _QUICK):
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu tests/` on the card")
    return dev

"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on the CPU with
xla_force_host_platform_device_count (SURVEY.md §4). The platform is pinned
with jax.config.update before any backend initializes, so the tests run on
the CPU whatever JAX_PLATFORMS says.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_prng_impl", "threefry2x32")


# ---------------------------------------------------------------------------
# Fast test tier: the tests below are the long-running convergence/parity
# runs (>= ~20 s each on a 1-core CPU host, by `pytest --durations`).
# `pytest -m "not slow"` is the fast tier; every traversal engine keeps a
# tiny-scene parity check there (tests/test_tracer_flags_fast.py), and
# the full suite is the gate.
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

_SLOW_TESTS = {
    "test_di_resampling.py::test_di_resampling_energy_unbiased",
    "test_di_resampling.py::test_di_resampling_modes_render_finite",
    "test_di_resampling.py::test_all_bias_modes_execute",
    "test_di_resampling.py::test_temporal_reuse_accumulates_history",
    "test_bvh.py::TestScatterTracer",
    "test_rmse.py",
    "test_frame.py::test_checkerboard_matches_full_grid",
    "test_frame.py::test_multichip_dryrun",
    "test_frame.py::test_accumulation_converges",
    "test_frame.py::test_gi_frame_finite",
    "test_frame.py::test_jit_compiles",
    "test_parallel.py::TestExplicitHaloFrame",
    "test_restir.py::TestDIBoilingFilter::test_frame_gated_by_gconst",
    "test_goldens.py",
    "test_frame.py::test_di_gi_temporal_spatial_sequence",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.replace("tests/", "", 1)
        parts = nodeid.split("::")
        candidates = {parts[0]}
        if len(parts) > 1:
            candidates.add("::".join(parts[:2]))
        if len(parts) > 2:
            candidates.add("::".join(parts[:3]))
        # strip parametrization ids
        candidates |= {c.split("[", 1)[0] for c in list(candidates)}
        if candidates & _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)

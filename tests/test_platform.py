"""Platform-facing choices made without a device: the traversal engine
picked per platform, the compile-cache directory, and chip_smoke.py's
refusal to run anywhere but on a GPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from raytracer2 import compile_cache
from raytracer2.render.app_bridge import resolve_backend

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform, engine", [("gpu", "bundle"),
                                              ("cpu", "bundle")])
def test_auto_engine_by_platform(platform, engine):
    assert resolve_backend(platform) == engine


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_auto_engine_refuses_other_platforms(platform):
    with pytest.raises(ValueError, match="no traversal engine"):
        resolve_backend(platform)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cache"))
    assert compile_cache.default_cache_dir() == tmp_path / "cache"


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.default_cache_dir() == REPO / ".jax_cache"


def _devices(*platforms):
    return [SimpleNamespace(platform=p) for p in platforms]


@pytest.mark.parametrize("platforms", [("cpu",), ("cpu",) * 8,
                                       ("gpu", "cpu"), ()])
def test_chip_smoke_refuses_non_gpu_devices(platforms):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_devices(_devices(*platforms))


def test_chip_smoke_accepts_gpus():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.check_devices(_devices("gpu", "gpu"))

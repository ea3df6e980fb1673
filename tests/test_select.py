"""The implementation selector, the compile-cache rule and the GPU-only
entry points (CPU tests)."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from sdrmodem.ops import select
from sdrmodem.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_select_gpu_runs_compiled_kernel():
    impl = select.select("gpu")
    assert impl == select.Impl("gpu", "kernel", False)


def test_select_cpu_runs_scan_and_interprets_kernels():
    impl = select.select("cpu")
    assert impl.clock == "scan" and impl.interpret is True


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal"])
def test_select_unknown_platform_raises_naming_it(platform):
    with pytest.raises(RuntimeError, match=platform):
        select.select(platform)


def test_select_defaults_to_first_device():
    assert select.select().platform == "cpu"  # the suite runs on the CPU


def test_clock_backend_explicit_default_and_unknown():
    assert select.clock_backend() == "scan"  # the CPU default
    assert select.clock_backend("kernel") == "kernel"
    with pytest.raises(ValueError, match="pallas"):
        select.clock_backend("pallas")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        select.require_gpu()


def test_compile_cache_follows_env_var(tmp_path):
    env = {compile_cache.ENV: str(tmp_path / "cache")}
    assert compile_cache.cache_dir(env) == tmp_path / "cache"


def test_compile_cache_defaults_to_fixed_checkout_path():
    path = compile_cache.cache_dir({})
    assert path == ROOT / ".jax_cache"
    assert compile_cache.cache_dir({}) == path  # no pid, time or tmp in it
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no" in r.stderr.lower() or "gpu" in r.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

"""Process-level runtime settings: compile-cache placement and the
device-memory budget of the index stage."""

import os
import subprocess
import sys

import pytest

from peregrine_tpu.config import AsmConfig
from peregrine_tpu.pipeline import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c", "import peregrine_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True,
        timeout=120).stdout.strip().splitlines()[-1]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert out == want


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,env,device_pairs,want", [
    # an 80 GB card with JAX's default 75% share
    ({"bytes_limit": 60_000_000_000}, None, False, 37_500_000_000),
    ({"bytes_limit": 60_000_000_000}, None, True, 22_500_000_000),
    # no allocator limit (the CPU backend): the fixed default
    (None, None, False, 10 << 30),
    # the override wins over the device, and still shrinks for pairs
    ({"bytes_limit": 60_000_000_000}, "123456789", True, 74_074_073),
])
def test_hbm_db_budget(monkeypatch, stats, env, device_pairs, want):
    import jax
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])
    if env is None:
        monkeypatch.delenv("PG_HBM_DB_BUDGET", raising=False)
    else:
        monkeypatch.setenv("PG_HBM_DB_BUDGET", env)
    cfg = AsmConfig(device_pairs=device_pairs)
    assert run._hbm_db_budget(cfg) == want

"""Entry points and surroundings: compile-cache placement, imports,
single-process distributed start-up, and chip_smoke.py and bench.py
refusing a machine without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from direct_lidar_odometry_tpu.utils import cachedir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))  # as JAX would
    assert cachedir.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cachedir.configure() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")
    assert cachedir.cache_dir() == cachedir.DEFAULT_DIR


def _python(code, **env):
    e = dict(os.environ, PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=e, timeout=300)


def test_runner_import_leaves_yaml_out():
    proc = _python(
        "import sys, bench, direct_lidar_odometry_tpu.odometry.runner;"
        "print('yaml' in sys.modules)", JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "False"


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


@pytest.mark.parametrize("mode", [[], ["--batch", "2"], ["--loop"]])
def test_bench_refuses_cpu_without_flag(mode):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--small", *mode],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
    assert "measures a GPU" in proc.stderr


def test_init_distributed_single_process_runs_alone():
    proc = _python(
        "import os, jax\n"
        "for k in ('JAX_COORDINATOR_ADDRESS', 'SLURM_JOB_ID',"
        " 'OMPI_MCA_orte_hnp_uri', 'KUBERNETES_SERVICE_HOST'):\n"
        "    os.environ.pop(k, None)\n"
        "from direct_lidar_odometry_tpu.parallel import sharded\n"
        "sharded.init_distributed()\n"
        "print(jax.distributed.is_initialized(), jax.process_count())",
        JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["False", "1"]

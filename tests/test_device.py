"""Device placement and the compile cache (smalt_tpu/device.py): the
device modes refuse a silent CPU fallback, and compiled programs go to
$JAX_COMPILATION_CACHE_DIR or, unset, to `.jax_cache` in the checkout."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    import jax
    from smalt_tpu import device
    if env_set:
        want = str(tmp_path / "cc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(REPO, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert device.ensure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_written_to_env_dir(tmp_path):
    """With the variable set, a compile lands in that directory."""
    cc = tmp_path / "cc"
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from smalt_tpu.device import ensure_compile_cache\n"
            "ensure_compile_cache()\n"
            "import jax, jax.numpy as jnp\n"
            "jax.config.update("
            "'jax_persistent_cache_min_compile_time_secs', 0)\n"
            "jax.jit(lambda x: jnp.cumsum(x) * 2)(jnp.arange(99))"
            ".block_until_ready()\n" % REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cc))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert any(n.startswith("jit_") for n in os.listdir(cc))


@pytest.mark.parametrize("flag", ["--fast", "--device-exact",
                                  "--device-pass1"])
def test_device_mode_refuses_silent_cpu(flag, tmp_path):
    """Started without JAX_PLATFORMS=cpu, a device mode that lands on
    the CPU exits non-zero and names the platform it found."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "smalt_tpu.cli", "map", flag,
         str(tmp_path / "noidx"), str(tmp_path / "noreads.fq")],
        env=env, capture_output=True, text=True, timeout=300)
    if "platform=cpu" not in r.stderr:
        pytest.skip("an accelerator is attached: " + r.stderr[-300:])
    assert r.returncode != 0
    assert "no accelerator found (JAX platform 'cpu')" in r.stderr


def test_requested_cpu_is_allowed(capsys, monkeypatch):
    from smalt_tpu.device import check_platform
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert check_platform("map --fast") is None
    line = capsys.readouterr().err.strip()
    assert line.startswith("# map --fast: platform=cpu device_kind=")
    assert " count=" in line

"""The pieces of `chip_smoke.py` and `bench.py` that do not need a GPU: the
device check, the closing line, the compile-cache location, and the HLO
scan for CIN's z buffers."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from recsys.core import compile_cache  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("script", [["chip_smoke.py"],
                                    ["chip_smoke.py", "--four"],
                                    ["bench.py"]])
def test_script_fails_without_gpu(script):
    proc = subprocess.run(
        [sys.executable] + script, cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.last_line(dev, count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert json.loads(line)["device"]["count"] == count


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_z_buffers_found_in_entry_computation():
    hlo = """HloModule m

fused_computation {
  p = f32[64,12]{1,0} parameter(0)
  ROOT m = f32[64,12]{1,0} multiply(p, p)
}

ENTRY main {
  a = f32[64,3]{1,0} parameter(0)
  z = f32[64,12]{1,0} fusion(a), kind=kLoop, calls=fused_computation
  t = (f32[8,8,12]{2,1,0}, f32[64,5]{1,0}) fusion(a), kind=kInput
  ROOT d = f32[64,5]{1,0} dot(z, a)
}
"""
    found = chip_smoke._z_buffers(hlo, {64 * 12})
    assert found == ["z f32[64,12] fusion kLoop",
                     "t f32[8,8,12] fusion kInput"]

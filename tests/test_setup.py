"""Process setup: compilation-cache location, the device peak table, and
the native library's rebuild-from-source rule."""

import os
import subprocess
import types

import jax
import pytest

from gcn_maxcut.bench.roofline import RooflineModel, device_specs
from gcn_maxcut.native import bindings
from gcn_maxcut.utils import cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_env_var(tmp_path, monkeypatch, restore_cache_dir):
    target = tmp_path / "xla"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert cache.enable_compilation_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_device_table_knows_h100():
    spec = device_specs("NVIDIA H100 80GB HBM3")
    assert (spec.hbm_gbps, spec.bf16_tflops, spec.tf32_tflops,
            spec.f32_tflops) == (3350.0, 989.0, 495.0, 67.0)
    model = RooflineModel(spec, feature_dim=128, n_nodes=100, n_edges=800)
    assert model.edges_per_s(fwd_bwd=True) == pytest.approx(
        model.edges_per_s(fwd_bwd=False) / 2
    )


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_device_table_rejects_unknown_kind(kind):
    with pytest.raises(ValueError, match="no peak table entry"):
        device_specs(kind)


def test_native_rebuilds_when_source_is_newer(tmp_path, monkeypatch):
    src, lib = tmp_path / "graphtools.cpp", tmp_path / "libgraphtools.so"
    src.write_text("// source")
    lib.write_bytes(b"old")
    os.utime(lib, (1_000, 1_000))
    os.utime(src, (2_000, 2_000))
    monkeypatch.setattr(bindings, "_SRC_PATH", src)
    monkeypatch.setattr(bindings, "_LIB_PATH", lib)
    monkeypatch.setattr(bindings, "_NATIVE_DIR", tmp_path)
    calls = []

    def fake_make(cmd, **kw):
        calls.append(cmd)
        out = cmd[-1].split("=", 1)[1]
        (tmp_path / out).write_bytes(b"new")
        return types.SimpleNamespace(returncode=0)

    monkeypatch.setattr(bindings.subprocess, "run", fake_make)
    assert bindings.build()
    assert len(calls) == 1 and lib.read_bytes() == b"new"
    assert not list(tmp_path.glob(".libgraphtools.so.*"))
    # now newer than the source: no rebuild
    assert bindings.build() and len(calls) == 1


def test_native_build_failure_leaves_no_partial_library(tmp_path, monkeypatch):
    src, lib = tmp_path / "graphtools.cpp", tmp_path / "libgraphtools.so"
    src.write_text("// source")
    monkeypatch.setattr(bindings, "_SRC_PATH", src)
    monkeypatch.setattr(bindings, "_LIB_PATH", lib)
    monkeypatch.setattr(bindings, "_NATIVE_DIR", tmp_path)

    def failing_make(cmd, **kw):
        (tmp_path / cmd[-1].split("=", 1)[1]).write_bytes(b"partial")
        raise subprocess.CalledProcessError(2, cmd)

    monkeypatch.setattr(bindings.subprocess, "run", failing_make)
    assert not bindings.build()
    assert not lib.exists()
    assert not list(tmp_path.glob(".libgraphtools.so.*"))

"""The platform query, the bandwidth peak table, compile-cache placement,
and chip_smoke.py's device refusal and host-f64 KKT certifier."""

import os

import numpy as np
import pytest

import hprlp_tpu
from hprlp_tpu import backend
from hprlp_tpu.params import Parameters


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_platform_query_supported(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    assert backend.platform() == name


@pytest.mark.parametrize("name", ["rocm", "METAL", "interpreter"])
def test_platform_query_unknown_raises(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()


def test_platform_query_here_is_cpu():
    assert backend.platform() == "cpu"


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12),
])
def test_peak_table_resolves_h100_kinds(kind, peak):
    import bench

    assert bench.peak_hbm_bytes_per_s(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "AMD Instinct MI300X"])
def test_peak_table_unknown_kind_raises(kind):
    import bench

    with pytest.raises(KeyError, match="no peak bandwidth"):
        bench.peak_hbm_bytes_per_s(kind)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/where"}, "/some/where"),
    ({}, "checkout"),
    ({"HPRLP_TPU_NO_COMPILE_CACHE": "1",
      "JAX_COMPILATION_CACHE_DIR": "/some/where"}, None),
])
def test_compile_cache_placement(env, want):
    got = hprlp_tpu.compile_cache_dir(env)
    if want == "checkout":
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            hprlp_tpu.__file__)))
        assert got == os.path.join(root, ".jax_cache")
    else:
        assert got == want


def test_lane_backend_rejected():
    with pytest.raises(ValueError, match="invalid spmv_backend"):
        Parameters(spmv_backend="lane").validate()


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu_device()
    assert e.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "no GPU" in out.err


def test_chip_smoke_certifier_accepts_known_optimum(demo_lp):
    """x = (2.8, 3.6) with duals y = (-2.4, -0.2), z = 0 is the exact
    optimum of the demo LP: KKT error ~1e-16."""
    import chip_smoke

    kkt = chip_smoke.certify_kkt(demo_lp, [2.8, 3.6], [-2.4, -0.2],
                                 [0.0, 0.0], 1e-12)
    assert kkt < 1e-12


@pytest.mark.parametrize("dx", [1e-2, -1e-2])
def test_chip_smoke_certifier_rejects_perturbed(demo_lp, dx):
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure, match="host-f64 KKT"):
        chip_smoke.certify_kkt(demo_lp, [2.8 + dx, 3.6], [-2.4, -0.2],
                               [0.0, 0.0], 1e-4)


def test_chip_smoke_highs_reference(demo_lp):
    import chip_smoke

    assert chip_smoke.highs_objective(demo_lp) == pytest.approx(-26.4,
                                                                rel=1e-9)
    assert np.isfinite(chip_smoke.highs_objective(demo_lp))

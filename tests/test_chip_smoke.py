"""``chip_smoke.py``: each phase at a tiny size on the CPU, the slab phase
on 4 virtual devices, the refusal to run without a GPU, and (marked
``gpu``) the real-size oracle checks on the card."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_phase_rigid2d_tiny(tmp_path):
    r = chip_smoke.phase_rigid2d(n=1000, out_dir=str(tmp_path), pfreq=10,
                                 chunks=2, oracle_steps=10)
    assert r["live"] > 0
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("snapshot_")]) == 3


def test_phase_dem2d_tiny():
    r = chip_smoke.phase_dem2d(n=1000, oracle_steps=10, chunk=5)
    assert r["live"] > 0


def test_phase_rigid3d_tiny():
    r = chip_smoke.phase_rigid3d(n=500, parity_steps=3, chunk=2)
    assert r["live"] > 0


def test_phase_sinking_box_tiny(tmp_path):
    r = chip_smoke.phase_sinking_box(spacing=0.1, max_steps=20,
                                     parity_steps=3,
                                     out_dir=str(tmp_path))
    assert r["live"] > 0


def test_phase_engine_timing_tiny():
    r = chip_smoke.phase_engine_timing(n_rigid=1000, n_dem=1000,
                                       n_rigid3d=300, chunk=2)
    assert set(r) == {(s, e) for s in ("rigid2d", "dem2d", "rigid3d")
                      for e in ("cell", "nklist")}
    assert all(v > 0 for v in r.values())


@pytest.mark.parametrize("scheme", ["rigid", "dem", "coupling"])
def test_four_device_slab_phase(scheme):
    """The --four-gpus path on 4 virtual CPU devices."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    n = {"rigid": 4000, "dem": 2000, "coupling": 2000}[scheme]
    getattr(chip_smoke, f"slab_{scheme}")(n_dev=4, n=n, steps=3)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    out = _run([script], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
def test_rigid2d_f32_on_gpu_matches_oracle(gpu, tmp_path):
    chip_smoke.phase_rigid2d(out_dir=str(tmp_path))


@pytest.mark.gpu
def test_dem2d_f32_on_gpu_matches_oracle(gpu):
    chip_smoke.phase_dem2d()

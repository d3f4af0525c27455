"""The platform decisions made in ``config``: the pair engine every
scheme runs, the compile-cache placement, and the precision of every
matrix product on the step path."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from rigid_body_2d_3d_pysph_tpu import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# ---------------------------------------------------------------------------
# engine selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform,env,expected", [
    ("cpu", None, "nklist"),
    ("gpu", None, "cell"),
    ("gpu", "nklist", "nklist"),
    ("cpu", "cell", "cell"),
])
def test_select_engine(monkeypatch, platform, env, expected):
    if env is None:
        monkeypatch.delenv("RB_ENGINE", raising=False)
    else:
        monkeypatch.setenv("RB_ENGINE", env)
    assert config.select_engine(platform) == expected


@pytest.mark.parametrize("platform,env", [
    ("gpu", "pallas"),      # a removed engine is not remapped
    ("cpu", "bogus"),
    ("rocm", None),         # no default for a platform without one
])
def test_select_engine_rejects(monkeypatch, platform, env):
    if env is None:
        monkeypatch.delenv("RB_ENGINE", raising=False)
    else:
        monkeypatch.setenv("RB_ENGINE", env)
    with pytest.raises(ValueError):
        config.select_engine(platform)


def _schemes():
    from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        RigidBody2DScheme,
    )
    from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
        RigidFluidCouplingScheme,
    )
    return {
        "rigid2d": lambda: RigidBody2DScheme(["body"], ["tank"], dim=2),
        "dem": lambda: DEMScheme(["sand"], ["floor"], dim=2),
        "coupling": lambda: RigidFluidCouplingScheme(
            ["fluid"], ["tank"], ["body"], dim=2, rho0=1.0, p0=1.0,
            c0=10.0, h=0.02, nu=0.0),
    }


@pytest.mark.parametrize("name", ["rigid2d", "dem", "coupling"])
def test_scheme_engine_follows_select_engine(monkeypatch, name):
    for env in ("cell", "nklist"):
        monkeypatch.setenv("RB_ENGINE", env)
        assert _schemes()[name]().engine == env


@pytest.mark.parametrize("name", ["rigid2d", "dem", "coupling"])
def test_scheme_engine_rejects_unknown(name):
    scheme = _schemes()[name]()
    for bad in ("pallas", "xla"):
        with pytest.raises(ValueError):
            scheme.engine = bad
    scheme.engine = "nklist"
    assert scheme.engine == "nklist"


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

_CACHE_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "import rigid_body_2d_3d_pysph_tpu\n"
    "jax.jit(lambda x: x * 2.0 + 1.0)(jnp.ones(7)).block_until_ready()\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    where = out.stdout.strip().splitlines()[-1]
    if from_env:
        assert where == str(tmp_path)
        assert os.listdir(tmp_path), "nothing was cached in the env dir"
    else:
        assert os.path.realpath(where) == os.path.join(
            os.path.realpath(ROOT), ".jax_cache")


# ---------------------------------------------------------------------------
# precision: no matrix product on the step path may run at DEFAULT, which
# XLA:GPU may lower to TF32
# ---------------------------------------------------------------------------

def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def _to_f32(scene):
    fields = {k: (v.astype(jnp.float32) if v.dtype == jnp.float64 else v)
              for k, v in scene.fields.items()}
    return type(scene)(fields, scene.meta)


def _step_case(name):
    import bench

    if name.startswith("coupling"):
        scheme, scene, dt = bench.build_coupling_scene(2000)
    else:
        build, dt = {"rigid2d": (bench.build_scene, 1e-4),
                     "rigid3d": (bench.build_scene_3d, 5e-5),
                     "dem": (bench.build_dem_scene, 5e-6)}[name.split("-")[0]]
        scheme, scene = build(1000)
    engine = name.split("-")[-1]
    scheme.engine = engine
    scheme.refresh_configs(scene)
    if name.startswith("coupling"):
        scheme.gtvf_ordering = "kdkf" if engine == "cell" else "kdk"
    return scheme, scene, dt


@pytest.mark.parametrize("name", ["rigid2d-cell", "rigid3d-cell", "dem-cell",
                                  "coupling-cell", "rigid2d-nklist",
                                  "coupling-nklist"])
def test_step_dots_run_at_highest_precision(name):
    scheme, scene, dt = _step_case(name)
    scene = _to_f32(scene)
    step = scheme.make_step(scene)
    jaxpr = jax.make_jaxpr(step)(scene, jnp.float32(dt)).jaxpr
    precs = _dot_precisions(jaxpr, [])
    if name.startswith(("rigid", "coupling")):
        assert precs, "expected the body-frame and slot contractions"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None, "dot_general at DEFAULT precision"
        for q in (p if isinstance(p, tuple) else (p,)):
            assert q == highest, p

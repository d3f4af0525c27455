"""Benchmark-4 restitution sweep through the native C++ f64 oracle.

Round-2 retired the monotone-rebound gate on an argued (but unproven)
claim that the reference's spring-dashpot contact model is not monotone
in the restitution coefficient at the case dt.  This script settles it
with data: the FULL benchmark-4 trajectory (same scene builder as the
case, identical eta matrix, 30k steps of the reference GTVF scheme) is
run through ``csrc/rbnative.cpp::rb_gtvf_step_n`` — an independent
implementation of the reference physics (``rigid_body_common.py``
pair loops) — for each coefficient of restitution, and the first-bounce
rebound height is recorded.

Output: ``cases/data/benchmark_4_oracle.json``
  {"en": {"heights": [...], "rebound": h_first_bounce}, ...}

validate.py's benchmark_4 check compares the JAX runs' rebound heights
against these oracle values (see check_benchmark_4).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "cases"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["RB_X64"] = "1"

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from rigid_body_2d_3d_pysph_tpu.native import gtvf_step_n  # noqa: E402


def build_scene(en: float):
    from benchmark_4_rigid_cube_bouncing_on_a_wall import Benchmark4

    app = Benchmark4(fname="benchmark_4_oracle")
    app._parse(["--coeff-of-restitution", str(en), "--quiet",
                "-d", "/tmp/b4_oracle_scratch"])
    scene = app.create_particles()
    return app, scene


def run_oracle(en: float, n_steps=30000, chunk=100):
    app, scene = build_scene(en)
    sch = app.scheme.scheme
    dt = 1e-4
    ys = []
    for start in range(0, n_steps, chunk):
        out = gtvf_step_n(scene, sch.kr, sch.kf, sch.fric_coeff,
                          sch.gx, sch.gy, sch.gz, dt, chunk, two_d=True)
        fdt = scene.x.dtype
        scene = scene.replace(
            x=jnp.asarray(out["x"], fdt), y=jnp.asarray(out["y"], fdt),
            u=jnp.asarray(out["u"], fdt), v=jnp.asarray(out["v"], fdt),
            xcm=jnp.asarray(out["xcm"], fdt),
            vcm=jnp.asarray(out["vcm"], fdt),
            R=jnp.asarray(out["R"], fdt),
            ang_mom=jnp.asarray(out["ang_mom"], fdt),
            omega=jnp.asarray(out["omega"], fdt),
            force=jnp.asarray(out["force"], fdt),
            torque=jnp.asarray(out["torque"], fdt),
            delta_lt_x=jnp.asarray(out["delta_lt"][0], fdt),
            delta_lt_y=jnp.asarray(out["delta_lt"][1], fdt),
            delta_lt_z=jnp.asarray(out["delta_lt"][2], fdt),
            fn_x=jnp.asarray(out["fn"][0], fdt),
            fn_y=jnp.asarray(out["fn"][1], fdt),
            fn_z=jnp.asarray(out["fn"][2], fdt),
        )
        ys.append(float(np.asarray(out["xcm"])[:, 1].mean()))
        if (start // chunk) % 30 == 0:
            print(f"en={en} step {start + chunk}/{n_steps} "
                  f"y={ys[-1]:.4f}", flush=True)
    return np.asarray(ys)


def first_rebound(ys):
    """Height regained after the first fall-and-bounce (same definition
    as validate.check_benchmark_4): first local minimum below start-0.05,
    then the following local maximum."""
    turn = [int(i) for i in np.where(np.diff(ys) > 0)[0]
            if ys[i] < ys[0] - 0.05]
    if not turn:
        return None
    t0 = turn[0]
    after = ys[t0:]
    peak = np.argmax(after)
    return float(after[peak] - ys[t0])


def run_jax_f64(en: float, n_steps=30000, chunk=100):
    """Same sweep through the JAX f64 production step (nklist engine on
    CPU) — the implementation half of validate.py's benchmark_4 gate."""
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import \
        make_multi_step

    app, scene = build_scene(en)
    sch = app.scheme.scheme
    step = sch.make_step(scene)
    multi = make_multi_step(step, chunk)
    dt = jnp.asarray(1e-4, scene.x.dtype)
    import numpy as _np
    ys = []
    s = scene
    for c in range(n_steps // chunk):
        s = multi(s, dt)
        ys.append(float(_np.asarray(s.xcm)[:, 1].mean()))
        if c % 30 == 0:
            print(f"[jax f64] en={en} step {(c + 1) * chunk}/{n_steps} "
                  f"y={ys[-1]:.4f}", flush=True)
    return np.asarray(ys)


def main():
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "cases", "data", "benchmark_4_oracle.json")
    if "--jax" in sys.argv:
        # refresh the jax_f64_rebound fields of an existing oracle json
        with open(out) as f:
            res = json.load(f)
        for en in ("1.0", "0.8", "0.5"):
            ys = run_jax_f64(float(en))
            res[en]["jax_f64_rebound"] = round(first_rebound(ys), 4)
            print(f"en={en}: jax f64 rebound="
                  f"{res[en]['jax_f64_rebound']} "
                  f"(oracle {res[en]['rebound']:.4f})", flush=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print("wrote", out, flush=True)
        return

    res = {}
    for en in ("1.0", "0.8", "0.5"):
        ys = run_oracle(float(en))
        res[en] = dict(heights=[round(float(v), 6) for v in ys[::10]],
                       rebound=first_rebound(ys),
                       y_min=float(ys.min()), y_final=float(ys[-1]))
        print(f"en={en}: rebound={res[en]['rebound']}", flush=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", out, flush=True)


if __name__ == "__main__":
    main()

"""Run the main path once on one NVIDIA GPU and check what comes out.

    python chip_smoke.py                  # phases 1-4 on one card
    python chip_smoke.py --engine-timing  # ... plus phase 5
    python chip_smoke.py --four-gpus      # the slab path on four cards

Phases (each at a size users run, each with live contact work):

1. rigid 2D contact, ~105k particles (``bench.build_scene``): three
   ``pfreq=100`` chunks through ``Solver`` with snapshot IO; per-particle
   force after 1 step and body state after 50 steps against the C++ f64
   oracle ``rb_gtvf_step_n``.
2. DEM 2D, ~100k grains packed at spacing 2r (``bench.build_dem_scene``):
   force after 1 step and grain state after 50 steps against the C++
   f64 oracle ``rb_dem_lvc_step_n``.
3. rigid 3D contact, ~100k particles (``bench.build_scene_3d``): the cell
   and nklist engines against each other.
4. the flagship sinking box through its case CLI (``--max-steps 1000``,
   ~33k particles): the body descends and stays finite; kdk parity of
   the two engines.
5. (``--engine-timing``) cell against nklist at the phase-1, -2 and -3
   sizes.

``--four-gpus`` runs only the slab path (``parallel/slab.py``) over a
1x4 mesh — rigid at ~1M particles, DEM and coupling — each against the
unsharded step on one card.

Every phase prints its particle count, live contacts, steps, compile
seconds, steady steps/s, peak device memory and each parity error beside
its tolerance.  A failed check raises, so the script exits non-zero and
prints no result; so does a machine without a GPU.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

The phase functions take their sizes as arguments; the tests run them at
tiny sizes on the CPU.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "cases"))

# float32 unit roundoff: every tolerance below that depends on f32
# rounding is a multiple of it
EPS32 = float(np.finfo(np.float32).eps)

# Tolerances of body state after many f32 steps, against the f64 oracle,
# the other engine or the unsharded step.  The reference's contact model
# has per-pair switches that f32 rounding can flip: "moving" is
# |v_ij| >= 1e-12 (below the f32 resolution of a velocity), "engaged" is
# overlap > 0, and the closest source is an argmin with lattice ties.  A
# flip changes one particle's force by up to kr * overlap, so single
# forces may differ by O(1) after a few steps while the body sums average
# many flips.  Measured on the CPU in f32 (9k-105k particles, 10-50
# steps): xcm within 1e-3 dx, vcm within 2% and omega * size within 5% of
# the velocity scale V = max(max|vcm|, g t).
TOL_XCM_DX = 1e-2
TOL_VCM_V = 5e-2
TOL_OMEGA_V = 1e-1


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def _say(phase, **kv):
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _check(phase, what, err, tol):
    """Print one parity error beside its tolerance; raise past it."""
    ok = bool(np.isfinite(err) and err <= tol)
    _say(phase, check=what, err=f"{err:.3e}", tol=f"{tol:.3e}",
         ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: {what} error {err:.3e} exceeds "
                             f"its tolerance {tol:.3e}")


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _time_chunks(step, scene, dt, chunk, n_chunks):
    """Compile a ``chunk``-step ``lax.scan`` program, run it once, then
    time ``n_chunks`` more after ``block_until_ready``.  Returns
    (final scene, compile seconds, steady steps/s)."""
    import jax

    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import make_multi_step

    multi = make_multi_step(step, chunk)
    t0 = time.perf_counter()
    compiled = multi.lower(scene, dt).compile()
    compile_s = time.perf_counter() - t0
    s = jax.block_until_ready(compiled(scene, dt))
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        s = compiled(s, dt)
    jax.block_until_ready(s)
    sps = chunk * n_chunks / (time.perf_counter() - t0)
    if bool(np.asarray(s.nbr_overflow)):
        raise AssertionError("neighbour capacity overflow while timing")
    if not np.isfinite(np.asarray(s.x)).all():
        raise AssertionError("non-finite positions while timing")
    return s, compile_s, sps


def _live_rigid(scene) -> int:
    """Engaged (particle, body-slot) contact pairs (overlap > 0)."""
    return int(np.sum(np.asarray(scene.overlap) > 0))


def _live_fsi(scene) -> int:
    """Body particles with fluid in their kernel support."""
    return int(np.sum(np.asarray(scene.wij_adami)[np.asarray(
        scene.is_rigid)] > 0))


def _body_size(scene) -> float:
    """Largest extent of one body: turns an omega error into a surface
    velocity error."""
    rb = np.asarray(scene.is_rigid)
    bid = np.asarray(scene.body_id)[rb]
    pts = np.stack([np.asarray(scene[k])[rb] for k in ("x", "y", "z")], 1)
    return max(float(np.max(np.ptp(pts[bid == b], axis=0)))
               for b in np.unique(bid))


def phase_rigid2d(n=105_000, out_dir=None, pfreq=100, chunks=3,
                  oracle_steps=50):
    """Phase 1: rigid 2D contact through ``Solver`` + the f64 oracle."""
    import jax
    import jax.numpy as jnp

    from bench import build_scene
    from rigid_body_2d_3d_pysph_tpu.app.application import Solver
    from rigid_body_2d_3d_pysph_tpu.native import gtvf_step_n

    name = "rigid2d"
    scheme, scene = build_scene(n)
    dt = 1e-4
    dtj = jnp.asarray(dt)
    dx = float(scene.meta.spacing0)
    prm = dict(kr=scheme.kr, kf=scheme.kf, fric_coeff=scheme.fric_coeff,
               gx=scheme.gx, gy=scheme.gy, gz=scheme.gz, dt=dt,
               two_d=True)
    step = scheme.make_step(scene)

    # steady rate of the Solver's own program: a pfreq-step scan chunk
    _, compile_s, sps = _time_chunks(step, scene, dtj, pfreq, 2)

    # the main path: Scheme.setup -> Solver.solve, snapshot IO included
    out_dir = out_dir or tempfile.mkdtemp(prefix="chip_smoke_rigid2d_")
    solver = Solver(scheme, scene, dt=dt, tf=chunks * pfreq * dt,
                    pfreq=pfreq, output_dir=out_dir)
    t0 = time.perf_counter()
    final = solver.solve(quiet=True)
    wall = time.perf_counter() - t0
    if bool(np.asarray(final.nbr_overflow)) or \
            not np.isfinite(np.asarray(final.x)).all():
        raise AssertionError(f"{name}: Solver run overflowed or diverged")
    if len(solver.output_files) != chunks + 1:
        raise AssertionError(f"{name}: expected {chunks + 1} snapshots, "
                             f"wrote {len(solver.output_files)}")

    # oracle: per-particle force of the first step's evaluation
    s1 = step(scene, dtj)
    live = _live_rigid(s1)
    ref = gtvf_step_n(scene, n_steps=1, **prm)
    f_j = np.stack([np.asarray(s1.fx), np.asarray(s1.fy)], 1)
    f_o = np.stack([ref["fx"], ref["fy"]], 1)
    fscale = float(np.max(np.abs(f_o)))
    # oracle: body state after oracle_steps steps
    s = scene
    for _ in range(oracle_steps):
        s = step(s, dtj)
    ref = gtvf_step_n(scene, n_steps=oracle_steps, **prm)
    vscale = _vscale(ref["vcm"], abs(scheme.gy) * oracle_steps * dt)

    _say(name, particles=scene.n, live_contacts=live,
         steps=chunks * pfreq, compile_s=f"{compile_s:.2f}",
         steady_steps_per_s=f"{sps:.2f}",
         solver_wall_s=f"{wall:.2f}", snapshots=len(solver.output_files),
         peak_bytes=_peak_bytes())
    if live <= 0:
        raise AssertionError(f"{name}: no live contact at step 1")
    # Step 1 starts at rest, so no switch can flip: only f32 rounding of
    # the overlap (~0.1 dx, known to ~EPS32*|x|/dx of itself) remains.
    _check(name, "force after 1 step / max|f|",
           _max_abs(f_j, f_o) / fscale, 1e-3)
    _check_bodies(name, f"after {oracle_steps} steps", s, ref, dx,
                  _body_size(scene), vscale)
    return dict(n=scene.n, live=live, compile_s=compile_s, sps=sps)


def _vscale(vcm, gt):
    """Velocity scale of a window: max(max|vcm|, g t)."""
    return max(float(np.max(np.abs(np.asarray(vcm)))), gt)


def _check_bodies(name, when, s, ref, dx, size, vscale):
    """Body state against a reference, with the TOL_* tolerances."""
    ref_x, ref_v, ref_w = (ref[k] for k in ("xcm", "vcm", "omega"))
    _check(name, f"xcm {when} / dx", _max_abs(s.xcm, ref_x) / dx,
           TOL_XCM_DX)
    _check(name, f"vcm {when} / V", _max_abs(s.vcm, ref_v) / vscale,
           TOL_VCM_V)
    _check(name, f"omega*size {when} / V",
           _max_abs(s.omega, ref_w) * size / vscale, TOL_OMEGA_V)


def _mobile(scene, groups):
    mob = np.zeros(scene.n, bool)
    for g in scene.meta.groups:
        if g.name in groups:
            mob[g.start:g.stop] = True
    return mob


def phase_dem2d(n=100_000, oracle_steps=50, chunk=50):
    """Phase 2: DEM 2D LVC against the f64 oracle."""
    import jax.numpy as jnp

    from bench import build_dem_scene
    from rigid_body_2d_3d_pysph_tpu.native import dem_lvc_step_n

    name = "dem2d"
    scheme, scene = build_dem_scene(n)
    dt = 5e-6
    dtj = jnp.asarray(dt)
    mob = _mobile(scene, scheme.granular_particles)
    step = scheme.make_step(scene)
    _, compile_s, sps = _time_chunks(step, scene, dtj, chunk, 2)

    s1 = step(scene, dtj)
    live = int(np.sum(np.asarray(s1.total_tng_contacts)))
    ref1 = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz,
                          dt, 1)
    s = scene
    for _ in range(oracle_steps):
        s = step(s, dtj)
    ref = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz,
                         dt, oracle_steps)

    _say(name, particles=scene.n, grains=int(mob.sum()), live_contacts=live,
         steps=3 * chunk + oracle_steps + 1, compile_s=f"{compile_s:.2f}",
         steady_steps_per_s=f"{sps:.2f}", peak_bytes=_peak_bytes())
    if live <= 0:
        raise AssertionError(f"{name}: no live contact at step 1")
    tol_f, tol_v, tol_x = _dem_tolerances(scheme, scene, mob,
                                          oracle_steps * dt)
    _check(name, "force after 1 step [N]",
           _max_abs(np.stack([s1.fx, s1.fy], 1)[mob],
                    np.stack([ref1["fx"], ref1["fy"]], 1)[mob]), tol_f)
    _check(name, f"u,v after {oracle_steps} steps [m/s]",
           _max_abs(np.stack([s.u, s.v], 1)[mob],
                    np.stack([ref["u"], ref["v"]], 1)[mob]), tol_v)
    _check(name, f"x,y after {oracle_steps} steps [m]",
           _max_abs(np.stack([s.x, s.y], 1)[mob],
                    np.stack([ref["x"], ref["y"]], 1)[mob]), tol_x)
    return dict(n=scene.n, live=live, compile_s=compile_s, sps=sps)


def _dem_tolerances(scheme, scene, mob, t):
    """(force [N], velocity [m/s], position [m]) tolerances of the f32
    DEM step over a window of length t.

    Grains touch at exactly 2r, so each overlap starts at the f32
    resolution of the positions, EPS32*max|x|: a contact force is known
    to kn*EPS32*max|x|, and a grain has at most 6 contacts.  That force
    error integrated over t bounds the velocity (df/m t, doubled) and
    position (df/m t^2 plus 4 roundings) errors."""
    xmax = float(np.max(np.abs(np.stack(
        [np.asarray(scene[k])[mob] for k in ("x", "y", "z")]))))
    df = 6.0 * scheme.kn * EPS32 * xmax
    m = float(np.min(np.asarray(scene.m)[mob]))
    return df, 2.0 * df / m * t, df / m * t * t + 4.0 * EPS32 * xmax


def _other_engine(engine):
    return "nklist" if engine == "cell" else "cell"


def phase_rigid3d(n=70_000, parity_steps=20, chunk=50):
    """Phase 3: rigid 3D contact; the two engines against each other."""
    import jax.numpy as jnp

    from bench import build_scene_3d

    name = "rigid3d"
    scheme, scene = build_scene_3d(n)
    dt = jnp.asarray(5e-5)
    engine = scheme.engine
    step = scheme.make_step(scene)
    _, compile_s, sps = _time_chunks(step, scene, dt, chunk, 2)
    scheme.engine = _other_engine(engine)
    other = scheme.make_step(scene)
    scheme.engine = engine

    a1, b1 = step(scene, dt), other(scene, dt)
    live = _live_rigid(a1)
    a, b = a1, b1
    for _ in range(parity_steps - 1):
        a, b = step(a, dt), other(b, dt)
    for s in (a, b):
        if bool(np.asarray(s.nbr_overflow)):
            raise AssertionError(f"{name}: neighbour capacity overflow")
    dx = float(scene.meta.spacing0)
    f_a = np.stack([a1.fx, a1.fy, a1.fz], 1)
    f_b = np.stack([b1.fx, b1.fy, b1.fz], 1)
    vscale = _vscale(b.vcm, abs(scheme.gy) * parity_steps * float(dt))

    _say(name, particles=scene.n, live_contacts=live,
         steps=3 * chunk + 2 * parity_steps, engine=engine,
         compile_s=f"{compile_s:.2f}", steady_steps_per_s=f"{sps:.2f}",
         peak_bytes=_peak_bytes())
    if live <= 0:
        raise AssertionError(f"{name}: no live contact at step 1")
    # same physics on the same f32 inputs; the engines differ only in the
    # order of their sums, and step 1 starts at rest (no switch flips)
    _check(name, "engines: force after 1 step / max|f|",
           _max_abs(f_a, f_b) / float(np.max(np.abs(f_b))), 1e-3)
    _check_bodies(name, f"engines, after {parity_steps} steps", a, b, dx,
                  _body_size(scene), vscale)
    return dict(n=scene.n, live=live, compile_s=compile_s, sps=sps)


def phase_sinking_box(spacing=0.02, max_steps=1000, parity_steps=20,
                      out_dir=None):
    """Phase 4: the flagship FSI case through its CLI, then kdk parity
    of the two engines on the same scene."""
    import jax
    import jax.numpy as jnp

    from rigid_body_rotating_and_sinking_in_tank_2d import SinkingBox

    name = "sinking_box"
    out_dir = out_dir or tempfile.mkdtemp(prefix="chip_smoke_sinking_")
    app = SinkingBox(fname="sinking_box")
    if spacing != 0.02:
        app.initialize(spacing=spacing)
    t0 = time.perf_counter()
    final = app.run(["--max-steps", str(max_steps), "-d", out_dir,
                     "--quiet"])
    wall = time.perf_counter() - t0
    scheme = app.scheme.scheme
    res = app.post_process()
    y_com = res["y_com"]
    if not all(np.isfinite(np.asarray(v)).all()
               for v in jax.device_get(final.fields).values()
               if np.issubdtype(np.asarray(v).dtype, np.floating)):
        raise AssertionError(f"{name}: non-finite state after the run")
    if not y_com[-1] < y_com[0]:
        raise AssertionError(f"{name}: the body did not descend "
                             f"(y_com {y_com[0]} -> {y_com[-1]})")
    live = _live_fsi(final)
    dt = jnp.asarray(app.scheme.dt)
    _, compile_s, sps = _time_chunks(scheme.make_step(final), final, dt,
                                     min(app.scheme.pfreq, max_steps), 2)

    # kdk parity: one scene, both engines, the same staging
    par = SinkingBox(fname="sinking_box_parity")
    par.initialize(spacing=spacing)
    par.scheme = par.create_scheme()
    pscheme = par.scheme.scheme
    pscheme.gtvf_ordering = "kdk"
    scene = par.create_particles()
    steps = []
    for eng in ("cell", "nklist"):
        pscheme.engine = eng
        pscheme.refresh_configs(scene)
        steps.append(pscheme.make_step(scene))
    a = b = scene
    for _ in range(parity_steps):
        a, b = steps[0](a, dt), steps[1](b, dt)
    fl = np.asarray(scene.is_fluid)
    vscale = float(np.max(np.abs(np.stack([np.asarray(b.u)[fl],
                                           np.asarray(b.v)[fl]], 1))))
    bscale = float(np.max(np.abs(np.asarray(b.vcm))))

    _say(name, particles=final.n, live_contacts=live, steps=max_steps,
         engine=scheme.engine, ordering=scheme.gtvf_ordering,
         case_wall_s=f"{wall:.2f}", compile_s=f"{compile_s:.2f}",
         steady_steps_per_s=f"{sps:.2f}",
         y_com=f"{y_com[0]:.5f}->{y_com[-1]:.5f}", peak_bytes=_peak_bytes())
    if live <= 0:
        raise AssertionError(f"{name}: no fluid-body contact")
    # same staging on both engines; f32 sums in another order only
    _check(name, f"kdk engines: fluid u,v after {parity_steps} steps "
           f"/ max|u|", _max_abs(np.stack([a.u, a.v], 1)[fl],
                                 np.stack([b.u, b.v], 1)[fl]) / vscale,
           1e-3)
    _check(name, f"kdk engines: body vcm after {parity_steps} steps "
           f"/ max|vcm|", _max_abs(a.vcm, b.vcm) / bscale, 1e-3)
    return dict(n=final.n, live=live, compile_s=compile_s, sps=sps)


def phase_engine_timing(n_rigid=105_000, n_dem=100_000, n_rigid3d=70_000,
                        chunk=50):
    """Phase 5: steady steps/s of cell and nklist on the phase-1, -2 and
    -3 scenes (the measurement behind ``config.select_engine``)."""
    import jax.numpy as jnp

    from bench import build_dem_scene, build_scene, build_scene_3d

    out = {}
    for label, build, dt, n in (("rigid2d", build_scene, 1e-4, n_rigid),
                                ("dem2d", build_dem_scene, 5e-6, n_dem),
                                ("rigid3d", build_scene_3d, 5e-5,
                                 n_rigid3d)):
        scheme, scene = build(n)
        for eng in ("cell", "nklist"):
            scheme.engine = eng
            scheme.refresh_configs(scene)
            _, compile_s, sps = _time_chunks(scheme.make_step(scene), scene,
                                             jnp.asarray(dt), chunk, 2)
            out[(label, eng)] = sps
            _say("engine_timing", scene=label, particles=scene.n,
                 engine=eng, compile_s=f"{compile_s:.2f}",
                 steady_steps_per_s=f"{sps:.2f}", peak_bytes=_peak_bytes())
    return out


def _slab_pair(name, scheme, scene, base, dt, n_dev, steps, make_step,
               compare):
    """Run the slab step over an n_dev mesh (global grid ``base``) and
    the unsharded step on one device for ``steps`` steps; check the HLO
    and compare."""
    import jax

    from rigid_body_2d_3d_pysph_tpu.parallel import slab as slabmod
    from rigid_body_2d_3d_pysph_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(n_dev)
    cfg = slabmod.make_slab_config(scene, base, n_dev)
    dec = slabmod.shard_slab_scene(slabmod.slab_decompose(scene, cfg), mesh)
    t0 = time.perf_counter()
    compiled = make_step(scheme, dec, mesh, cfg).lower(dec, dt).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    if "all-gather" in hlo:
        raise AssertionError(f"slab {name}: the HLO all-gathers")
    if "collective-permute" not in hlo:
        raise AssertionError(f"slab {name}: no collective-permute halo")
    ref_step = scheme.make_step(scene)
    s_ref, s_slab = scene, dec
    s_slab = jax.block_until_ready(compiled(s_slab, dt))
    s_ref = ref_step(s_ref, dt)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        s_slab = compiled(s_slab, dt)
    jax.block_until_ready(s_slab)
    sps = (steps - 1) / (time.perf_counter() - t0)
    for _ in range(steps - 1):
        s_ref = ref_step(s_ref, dt)
    if bool(np.asarray(s_slab.nbr_overflow)):
        raise AssertionError(f"slab {name}: halo or grid overflow")
    _say(f"slab_{name}", particles=scene.n, devices=n_dev, steps=steps,
         halo_cap=cfg.halo_cap, compile_s=f"{compile_s:.2f}",
         steady_steps_per_s=f"{sps:.2f}", peak_bytes=_peak_bytes())
    compare(f"slab_{name}", s_slab, s_ref)


def _compare_bodies(scene, live_fn, gt):
    """Body-state comparison for the rigid and coupling slab phases
    (psum of per-device partial sums over per-device grids: only the
    order of the f32 sums differs from the unsharded step)."""
    dx = float(scene.meta.spacing0)
    size = _body_size(scene)

    def compare(name, s_slab, s_ref):
        live = live_fn(s_ref)
        _say(name, live_contacts=live)
        if live <= 0:
            raise AssertionError(f"{name}: no live contact")
        _check_bodies(name, "vs unsharded", s_slab, s_ref, dx, size,
                      _vscale(s_ref.vcm, gt))
    return compare


def _compare_grains(scheme, scene, t):
    """Per-grain comparison for the DEM slab phase (rows matched by gid),
    with the tolerances of phase 2 over the window t."""
    mob = _mobile(scene, scheme.granular_particles)
    _, tol_v, tol_x = _dem_tolerances(scheme, scene, mob, t)

    def compare(name, s_slab, s_ref):
        act = np.asarray(s_slab.active)
        gid = np.asarray(s_slab.gid)[act]
        live = int(np.sum(np.asarray(s_ref.total_tng_contacts)))
        _say(name, live_contacts=live)
        if live <= 0:
            raise AssertionError(f"{name}: no live contact")
        if len(gid) != s_ref.n:
            raise AssertionError(f"{name}: {len(gid)} active rows, "
                                 f"expected {s_ref.n}")
        for keys, tol, unit in ((("x", "y"), tol_x, "m"),
                                (("u", "v"), tol_v, "m/s")):
            a = np.stack([np.asarray(s_slab[k])[act] for k in keys], 1)
            b = np.stack([np.asarray(s_ref[k])[gid] for k in keys], 1)
            _check(name, f"{','.join(keys)} vs unsharded [{unit}]",
                   _max_abs(a, b), tol)
    return compare


def _cell_grid(scheme, scene):
    """The global cell grid of a slab run (the slab path is built on the
    cell grid, so the scheme is set to the cell engine)."""
    from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel

    scheme.engine = "cell"
    scheme.refresh_configs(scene)
    if hasattr(scheme, "granular_particles"):
        return scheme.cell_config(scene)
    return scheme.cell_config(scene, get_kernel(scheme.kernel_name,
                                                scheme.dim))


def slab_rigid(n_dev=4, n=1_000_000, steps=20):
    """Slab rigid contact step (~1M particles at rest in contact)."""
    import jax.numpy as jnp

    from bench import build_scene
    from rigid_body_2d_3d_pysph_tpu.parallel import slab as slabmod

    scheme, scene = build_scene(n)
    dt = 1e-4
    _slab_pair("rigid", scheme, scene, _cell_grid(scheme, scene),
               jnp.asarray(dt), n_dev, steps, slabmod.make_slab_step,
               _compare_bodies(scene, _live_rigid, 9.81 * steps * dt))


def slab_dem(n_dev=4, n=200_000, steps=20):
    """Slab DEM step with gid-keyed contact tables."""
    import jax.numpy as jnp

    from bench import build_dem_scene
    from rigid_body_2d_3d_pysph_tpu.parallel import slab as slabmod

    scheme, scene = build_dem_scene(n)
    scene = slabmod.attach_gids(scene)
    dt = 5e-6
    _slab_pair("dem", scheme, scene, _cell_grid(scheme, scene),
               jnp.asarray(dt), n_dev, steps,
               lambda sch, dec, mesh, cfg: slabmod.make_slab_dem_step(
                   sch, dec, mesh, cfg, scene.n),
               _compare_grains(scheme, scene, steps * dt))


def slab_coupling(n_dev=4, n=100_000, steps=20):
    """Slab rigid-fluid coupling step (the sinking box, kdkf staging)."""
    import jax.numpy as jnp

    from bench import build_coupling_scene
    from rigid_body_2d_3d_pysph_tpu.parallel import slab as slabmod

    scheme, scene, dt = build_coupling_scene(n)
    _slab_pair("coupling", scheme, scene, _cell_grid(scheme, scene),
               jnp.asarray(dt), n_dev, steps,
               slabmod.make_slab_coupling_step,
               _compare_bodies(scene, _live_fsi,
                               abs(scheme.gy) * steps * dt))


def phase_slab(n_dev=4, n_rigid=1_000_000, n_dem=200_000,
               n_coupling=100_000, steps=20):
    """The slab path of the three schemes over an n_dev mesh, each
    against the unsharded step on one device."""
    slab_rigid(n_dev, n_rigid, steps)
    slab_dem(n_dev, n_dem, steps)
    slab_coupling(n_dev, n_coupling, steps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the slab path over four cards")
    p.add_argument("--engine-timing", action="store_true",
                   help="also time cell against nklist (phase 5)")
    args = p.parse_args(argv)

    from bench import card_line, device_info, require_gpu

    require_gpu()
    dev = device_info()
    print(f"card: {card_line()}", flush=True)
    print(f"device_kind={dev['kind']} device_count={dev['count']}",
          flush=True)
    if args.four_gpus:
        if dev["count"] < 4:
            raise SystemExit(f"--four-gpus needs 4 GPUs, found "
                             f"{dev['count']}")
        phase_slab(n_dev=4)
    else:
        phase_rigid2d()
        phase_dem2d()
        phase_rigid3d()
        phase_sinking_box()
        if args.engine_timing:
            phase_engine_timing()
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()

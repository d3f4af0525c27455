"""Throughput benchmark: contact-scheme steps/sec at ~100k particles.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/sec", "device": {...}}

Workload (``BENCH_WORKLOAD``): the rigid-body contact pipeline
(benchmark-3 physics: bodies resting in a tank, full Mofidi contact +
GTVF step) at ~``BENCH_N`` particles, 2D, float32 by default;
``rigid3d``, ``dem``, ``dem3d``, ``coupling`` and ``slab`` select the
other schemes.  Every scene starts in contact.  The pair engine is the
one ``config.select_engine`` picks (``RB_ENGINE`` overrides it).

The benchmark measures the GPU and nothing else: without one it exits
with an error instead of timing the CPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_STEPS = int(os.environ.get("BENCH_STEPS", 200))


def require_gpu():
    """The first JAX device, which must be a GPU; exits otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r} devices "
                         f"only; this measures the GPU and does not fall "
                         f"back to the CPU")
    return dev


def device_info() -> dict:
    """The device as JAX reports it (platform, kind, count)."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """The cards' names and power limits as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def n_target() -> int:
    """BENCH_N, read at call time (not import time)."""
    return int(os.environ.get("BENCH_N", 100_000))


def build_scene(n=None):
    """~n-particle 2D rigid contact scene: 8 bodies in two stacked rows
    in a tank.  The bottom row rests on the floor (its top layer is at
    y = -dx) and the top row on the bottom row, each with a gap of
    0.9 dx, so contacts are live from step 0."""
    from rigid_body_2d_3d_pysph_tpu.geom import (
        get_2d_block, create_tank_2d_from_block_2d,
    )
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import RigidBody2DScheme
    from rigid_body_2d_3d_pysph_tpu.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
    )

    n_bodies = 8
    side = max(int(np.sqrt(max(n or n_target(), 1000) / n_bodies)), 12)
    dx = 0.2 / (side - 1)
    gap = 0.9 * dx
    xb1, yb1 = get_2d_block(dx, 0.2, 0.2)
    xs, ys, bid = [], [], []
    for b in range(n_bodies):
        col, row = b % 4, b // 4
        xs.append(xb1 + col * 0.25)
        ys.append(yb1 - yb1.min() - dx + gap + row * (0.2 + gap))
        bid.append(np.full(len(xb1), b, np.int32))
    xb, yb = np.concatenate(xs), np.concatenate(ys)
    bid = np.concatenate(bid)
    xt, yt = create_tank_2d_from_block_2d(
        np.array([-0.15, 1.1]), np.array([0.0, 1.2]), 1.25, 1.2, dx, 3)
    m = 2000.0 * dx * dx
    body = make_group("body", xb, yb, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID, body_id=bid, dem_id=bid,
                      constants={"E": 69e9, "poisson_ratio": 0.3})
    tank = make_group("tank", xt, yt, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies,
                      constants={"E": 69e9, "poisson_ratio": 0.3})
    scene = build_scene([body, tank], dim=2, total_no_bodies=n_bodies + 1,
                        spacing0=dx)
    scheme = RigidBody2DScheme(rigid_bodies=["body"], boundaries=["tank"],
                               gy=-9.81, dim=2)
    scene = scheme.setup(scene)
    return scheme, scene


def build_scene_3d(n=None):
    """~n-particle 3D contact scene (benchmark-5-3d-like): 8 cubes
    resting on a floor slab with a gap of 0.9 dx, on the 27-cell
    stencil path."""
    from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import RigidBody3DScheme
    from rigid_body_2d_3d_pysph_tpu.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
    )

    n_bodies = 8
    side = max(int(round((max(n or n_target(), 1000) / n_bodies)
                         ** (1 / 3))), 5)
    dx = 0.2 / (side - 1)
    xb1, yb1, zb1 = get_3d_block(dx, 0.2, 0.2, 0.2)
    xs, zs, bid = [], [], []
    for b in range(n_bodies):
        col, row = b % 4, b // 4
        xs.append(xb1 + col * 0.25)
        zs.append(zb1 + row * 0.25)
        bid.append(np.full(len(xb1), b, np.int32))
    xb = np.concatenate(xs)
    yb = np.tile(yb1, n_bodies)
    zb = np.concatenate(zs)
    bid = np.concatenate(bid)
    # floor slab, 3 layers; its top layer 0.9 dx below the cubes
    gx = np.arange(-0.2, 1.3, dx)
    gz = np.arange(-0.2, 0.7, dx)
    fx, fz = np.meshgrid(gx, gz)
    xf = np.tile(fx.ravel(), 3)
    zf = np.tile(fz.ravel(), 3)
    yf = np.repeat(yb.min() - 0.9 * dx - dx * np.arange(3), fx.size)
    m = 2000.0 * dx**3
    body = make_group("body", xb, yb, z=zb, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID, body_id=bid,
                      dem_id=bid,
                      constants={"E": 69e9, "poisson_ratio": 0.3})
    floor = make_group("floor", xf, yf, z=zf, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies,
                       constants={"E": 69e9, "poisson_ratio": 0.3})
    scene = build_scene([body, floor], dim=3, total_no_bodies=n_bodies + 1,
                        spacing0=dx)
    scheme = RigidBody3DScheme(rigid_bodies=["body"], boundaries=["floor"],
                               gy=-9.81, dim=3)
    scene = scheme.setup(scene)
    return scheme, scene


def build_dem_scene(n=None):
    """~n-grain column over a floor (the dem_granular_column_collapse
    geometry scaled up), packed at spacing 2r so neighbouring grains and
    the floor touch from step 0."""
    from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block
    from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme
    from rigid_body_2d_3d_pysph_tpu.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
    )

    radius, rho = 1e-3, 2600.0
    s = 2.0 * radius
    k = np.sqrt(max(n or n_target(), 1000) / 1250.0)
    w, h = 0.05 * k, 0.1 * k
    xg, yg = get_2d_block(s, w, h)
    yg -= yg.min() - radius
    m = rho * np.pi * radius**2
    grains = make_group("sand", xg, yg, m=m, h=2.0 * radius, rho=rho,
                        rad_s=radius, role=ROLE_RIGID,
                        body_id=np.arange(len(xg), dtype=np.int32),
                        dem_id=0)
    xf = np.arange(-3.5 * h, 3.5 * h, 2 * radius)
    yf = np.full(len(xf), -radius)
    floor = make_group("floor", xf, yf, m=m, h=2.0 * radius, rho=rho,
                       rad_s=radius, role=ROLE_BOUNDARY, dem_id=1)
    scene = build_scene([grains, floor], dim=2, total_no_bodies=2,
                        spacing0=s)
    scheme = DEMScheme(granular_particles=["sand"], boundaries=["floor"],
                       kn=1e5, en=0.5, mu=0.5, dim=2, gy=-9.81,
                       max_tng_contacts_limit=8)
    scene = scheme.setup(scene)
    return scheme, scene


def build_dem_scene_3d(n=None):
    """~n-sphere 3D granular column over a floor plane (the reference
    DEM is sphere-sphere 3D, code/dem.py:35-205), packed at spacing 2r."""
    from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme
    from rigid_body_2d_3d_pysph_tpu.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
    )

    radius, rho = 1e-3, 2600.0
    s = 2.0 * radius
    base = (0.05 * 0.1 * 0.05) / s**3           # grains at unit scale
    k = (max(n or n_target(), 1000) / base) ** (1.0 / 3.0)
    w, h, d = 0.05 * k, 0.1 * k, 0.05 * k
    ax = np.arange(0.0, w, s)
    ay = np.arange(0.0, h, s)
    az = np.arange(0.0, d, s)
    gx_, gy_, gz_ = np.meshgrid(ax, ay, az)
    xg, yg, zg = gx_.ravel(), gy_.ravel(), gz_.ravel()
    yg = yg - yg.min() + radius
    m = rho * (4.0 / 3.0) * np.pi * radius**3
    grains = make_group("sand", xg, yg, z=zg, m=m, h=2.0 * radius,
                        rho=rho, rad_s=radius, role=ROLE_RIGID,
                        body_id=np.arange(len(xg), dtype=np.int32),
                        dem_id=0)
    fx_, fz_ = np.meshgrid(np.arange(-1.5 * w, 2.5 * w, 2 * radius),
                           np.arange(-1.5 * d, 2.5 * d, 2 * radius))
    xf, zf = fx_.ravel(), fz_.ravel()
    yf = np.full(len(xf), -radius)
    floor = make_group("floor", xf, yf, z=zf, m=m, h=2.0 * radius,
                       rho=rho, rad_s=radius, role=ROLE_BOUNDARY,
                       dem_id=1)
    scene = build_scene([grains, floor], dim=3, total_no_bodies=2,
                        spacing0=s)
    scheme = DEMScheme(granular_particles=["sand"], boundaries=["floor"],
                       kn=1e5, en=0.5, mu=0.5, dim=3, gy=-9.81,
                       max_tng_contacts_limit=8)
    scene = scheme.setup(scene)
    return scheme, scene


def build_coupling_scene(n=None):
    """~n-particle rigid-fluid coupling scene: the sinking-box FSI case
    (Sun 2015; the reference's largest workload) with the particle
    spacing scaled to hit the target count."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "cases"))
    from rigid_body_rotating_and_sinking_in_tank_2d import SinkingBox

    app = SinkingBox(fname="bench_coupling")
    # the stock case is ~33k particles at dx=0.02; scale dx through the
    # case's own initialize so every spacing-derived quantity (h, dt)
    # comes from one place
    scale = np.sqrt(33_000.0 / max(n or n_target(), 2000))
    app.initialize(spacing=0.02 * scale)
    app.scheme = app.create_scheme()
    app.scheme.configure(dim=2)
    scheme = app.scheme.scheme
    scene = app.create_particles()
    dt = 0.25 * app.fluid_spacing * app.hdx / (app.co * 1.1)
    return scheme, scene, dt


def measure_slab(n_steps: int) -> dict:
    """BENCH_WORKLOAD=slab: the slab-sharded step (shard_map + ppermute)
    on a 1-device mesh vs the plain unsharded step — the per-step
    overhead of the multi-device path's decomposition/halo machinery."""
    import jax
    import jax.numpy as jnp
    from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu.parallel import slab as slabmod
    from rigid_body_2d_3d_pysph_tpu.parallel.sharded import make_mesh

    scheme, scene = build_scene()
    scheme.engine = "cell"   # the slab path is built on the cell grid
    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    base = scheme.cell_config(scene, kernel)
    dt = jnp.asarray(1e-4)

    def time_chain(stepfn, state, per_call=1):
        out = stepfn(state, dt)
        jax.block_until_ready(out.fields["x"])
        t0 = time.perf_counter()
        s = out
        for _ in range(n_steps):
            s = stepfn(s, dt)
        jax.block_until_ready(s.fields["x"])
        assert not bool(np.asarray(s.nbr_overflow).any())
        return n_steps * per_call / (time.perf_counter() - t0)

    plain_sps = time_chain(scheme.make_step(scene), scene)
    mesh = make_mesh(1)
    cfg = slabmod.make_slab_config(scene, base, 1)
    dec = slabmod.shard_slab_scene(slabmod.slab_decompose(scene, cfg), mesh)
    # chain steps inside the shard_map: one dispatch per 10 steps, like
    # the plain path's scan chunks
    chain = 10
    slab_step = slabmod.make_slab_step(scheme, dec, mesh, cfg, chain=chain)
    slab_sps = time_chain(slab_step, dec, per_call=chain)
    return dict(steps_per_sec=slab_sps, plain_steps_per_sec=plain_sps,
                n=scene.n, engine="cell")


def measure(n_steps: int) -> dict:
    import jax
    import jax.numpy as jnp
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import make_multi_step

    workload = os.environ.get("BENCH_WORKLOAD", "rigid")
    if workload == "slab":
        return measure_slab(min(n_steps, 100))
    builders = {"rigid": (build_scene, 1e-4), "rigid3d": (build_scene_3d, 5e-5),
                "dem": (build_dem_scene, 5e-6),
                "dem3d": (build_dem_scene_3d, 5e-6)}
    if workload == "coupling":
        scheme, scene, dt_f = build_coupling_scene()
    else:
        build, dt_f = builders[workload]
        scheme, scene = build()
    dt = jnp.asarray(dt_f)
    chunk = min(n_steps, 50)
    multi = make_multi_step(scheme.make_step(scene), chunk)

    # warmup/compile
    s = multi(scene, dt)
    jax.block_until_ready(s.fields["x"])

    done = 0
    t0 = time.perf_counter()
    while done < n_steps:
        s = multi(s, dt)
        done += chunk
    jax.block_until_ready(s.fields["x"])
    el = time.perf_counter() - t0
    assert not bool(np.asarray(s.nbr_overflow)), "neighbor overflow"
    assert np.isfinite(np.asarray(s.fields["x"])).all()
    return dict(steps_per_sec=done / el, n=scene.n, engine=scheme.engine)


if __name__ == "__main__":
    require_gpu()
    dev = device_info()
    r = measure(N_STEPS)
    workload = os.environ.get("BENCH_WORKLOAD", "rigid")
    where = f"{dev['kind']} x{dev['count']}, {r['engine']} engine"
    if workload == "slab":
        eff = r["steps_per_sec"] / r["plain_steps_per_sec"]
        metric = (f"slab-sharded contact steps/sec @ {r['n']} particles "
                  f"(1-device mesh on {where}; plain step "
                  f"{r['plain_steps_per_sec']:.1f}/s -> slab efficiency "
                  f"{100 * eff:.0f}%)")
    else:
        name = {"rigid": "rigid-contact", "rigid3d": "rigid-contact-3d",
                "dem": "DEM-LVC", "dem3d": "DEM-LVC-3d",
                "coupling": "rigid-fluid-coupling"}[workload]
        metric = f"{name} steps/sec @ {r['n']} particles ({where})"
    print(json.dumps({"metric": metric, "value": r["steps_per_sec"],
                      "unit": "steps/sec", "device": dev}))

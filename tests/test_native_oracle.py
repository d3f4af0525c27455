"""Cross-validation: the JAX contact pipeline vs the independent native
C++ engine (csrc/rbnative.cpp) on a multi-body contact scene."""

import numpy as np
import jax
import jax.numpy as jnp

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
    _attach_contact_fields,
)
from rigid_body_2d_3d_pysph_tpu.native import contact_eval, neighbor_counts
from rigid_body_2d_3d_pysph_tpu.ops import contact as cops
from rigid_body_2d_3d_pysph_tpu.ops import neighbors as nbmod
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as rs


def _scene():
    """Two overlapping cubes + a wall segment, with nonzero velocities."""
    dx = 0.05
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    # overlap the bodies slightly and the wall below
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-10, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    body = make_group("body", x, y, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_BOUNDARY,
                      dem_id=2)
    scene = build_scene([body, wall], dim=2, total_no_bodies=3, spacing0=dx)
    scene = rs.setup_body_state(scene)
    scene = _attach_contact_fields(scene)
    n = scene.n
    # everything is a contact surface for this test
    scene = scene.replace(
        contact_force_is_boundary=jnp.ones(n, scene.x.dtype))
    # some relative motion
    rng = np.random.default_rng(3)
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    scene = scene.replace(u=jnp.asarray(u, scene.x.dtype),
                          v=jnp.asarray(v, scene.x.dtype))
    return scene, dx


def test_contact_pipeline_matches_native():
    scene, dx = _scene()
    kernel = QuinticSpline(dim=2)
    kr, kf, mu, dt = 1e5, 1e3, 0.5, 1e-4
    cutoff = 3 * 1.3 * dx

    nbrs = nbmod.brute_force_neighbors(scene.x, scene.y, scene.z,
                                       scene.active, cutoff, 128)

    @jax.jit
    def run(scene):
        cx, cy, cz, cw = cops.contact_force_normals(scene, nbrs, kernel)
        dinfo = cops.contact_force_distance(scene, nbrs, kernel, cx, cy, cz)
        dfx, dfy, dfz, slots = cops.contact_force(
            scene, dt, kr, kf, mu, cx, cy, cz, dinfo,
            scene.delta_lt_x, scene.delta_lt_y, scene.delta_lt_z,
            scene.fn_x, scene.fn_y, scene.fn_z)
        return cx, cy, cz, dinfo["contact_force_dist"], dfx, dfy, dfz, slots

    cx, cy, cz, dist, dfx, dfy, dfz, slots = run(scene)

    arrays = {k: np.asarray(scene[k]) for k in
              ("x", "y", "z", "u", "v", "w", "m", "rho", "h", "dem_id",
               "body_id", "is_rigid", "contact_force_is_boundary")}
    nat = contact_eval(arrays, S=3, dim=2, spacing0=dx,
                       eta=np.asarray(scene.eta), kr=kr, kf=kf,
                       fric_coeff=mu, dt=dt)

    np.testing.assert_allclose(np.asarray(cx), nat["cfn_x"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(cy), nat["cfn_y"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(dist), nat["dist"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(dfx), nat["fx"], rtol=1e-9,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(dfy), nat["fy"], rtol=1e-9,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(slots["delta_lt_x"]),
                               nat["delta_lt"][0], atol=1e-10)
    np.testing.assert_allclose(np.asarray(slots["fn_y"]), nat["fn"][1],
                               rtol=1e-9, atol=1e-6)


def test_grid_matches_native_counts():
    rng = np.random.default_rng(7)
    n = 400
    x = rng.uniform(-1, 1, n)
    y = rng.uniform(-1, 1, n)
    z = rng.uniform(-1, 1, n)
    cutoff = 0.3
    nat = neighbor_counts(x, y, z, cutoff)
    cfg = nbmod.NeighborConfig(cutoff=cutoff, max_neighbors=96,
                               max_per_cell=64, dim=3, n_buckets=1 << 12,
                               row_chunk=128)
    nl = nbmod.build_neighbors(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(z), jnp.ones(n, bool), cfg)
    np.testing.assert_array_equal(np.asarray(nl.n_neighbors), nat)


def test_native_gtvf_trajectory_matches_jax():
    """Multi-step oracle: 150 GTVF steps of the full rigid scheme in the
    independent C++ engine vs the JAX step (f64), including the
    persistent contact-state handoff between steps."""
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        RigidBody2DScheme,
    )
    from rigid_body_2d_3d_pysph_tpu.native import gtvf_step_n

    dx = 0.05
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-10, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    body = make_group("body", x, y, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_BOUNDARY,
                      dem_id=2)
    scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                        spacing0=dx)
    scheme = RigidBody2DScheme(rigid_bodies=["body"], boundaries=["wall"],
                               gy=-9.81, dim=2)
    scheme.engine = "nklist"
    scene = scheme.setup(scene)
    scene = scheme.set_linear_velocity(
        scene, np.array([[0.3, 0.0, 0.0], [-0.3, 0.0, 0.0]]))

    dt, n_steps = 1e-4, 150
    native = gtvf_step_n(scene, kr=scheme.kr, kf=scheme.kf,
                         fric_coeff=scheme.fric_coeff, gx=0.0, gy=-9.81,
                         gz=0.0, dt=dt, n_steps=n_steps, two_d=True)

    step = scheme.make_step(scene)
    s = scene
    for _ in range(n_steps):
        s = step(s, jnp.asarray(dt))
    assert not bool(np.asarray(s.nbr_overflow))

    np.testing.assert_allclose(native["xcm"], np.asarray(s.xcm),
                               atol=1e-8)
    np.testing.assert_allclose(native["vcm"], np.asarray(s.vcm),
                               atol=1e-7)
    np.testing.assert_allclose(native["omega"], np.asarray(s.omega),
                               atol=1e-6)
    np.testing.assert_allclose(native["x"], np.asarray(s.x), atol=1e-8)
    np.testing.assert_allclose(native["y"], np.asarray(s.y), atol=1e-8)
    np.testing.assert_allclose(native["u"], np.asarray(s.u), atol=1e-7)
    np.testing.assert_allclose(native["force"], np.asarray(s.force),
                               rtol=1e-8, atol=1e-6)


def test_native_dem_lvc_trajectory_matches_jax():
    """25 full DEM LVC steps: the independent C++ oracle
    (rb_dem_lvc_step_n) vs the JAX nklist engine, f64.  Tables compared
    as (source idx, dem) -> spring maps (slot order is
    allocation-order dependent and never enters the physics)."""
    import sys
    sys.path.insert(0, "tests")
    from test_dem_cell import _grain_scene

    from rigid_body_2d_3d_pysph_tpu.native import dem_lvc_step_n

    scheme, scene = _grain_scene(seed=11)
    scheme.engine = "nklist"
    step = scheme.make_step(scene)
    dt = 1e-5
    s = scene
    for _ in range(25):
        s = step(s, jnp.asarray(dt))

    mob = np.zeros(scene.n, bool)
    g = scene.meta.group("grains")
    mob[g.start:g.stop] = True
    out = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz,
                         dt, 25)

    for k in ("x", "y", "u", "v", "wz", "fx", "fy", "torz"):
        np.testing.assert_allclose(out[k], np.asarray(s[k]), atol=1e-10,
                                   err_msg=k)

    def table_map(ti, td, ta, tb, tc):
        maps = []
        for r in range(ti.shape[0]):
            maps.append({(int(i), int(d)): (ta[r, l], tb[r, l], tc[r, l])
                         for l, (i, d) in enumerate(zip(ti[r], td[r]))
                         if i >= 0})
        return maps

    m_j = table_map(np.asarray(s.tng_idx), np.asarray(s.tng_idx_dem_id),
                    np.asarray(s.tng_x), np.asarray(s.tng_y),
                    np.asarray(s.tng_z))
    m_n = table_map(out["tng_idx"], out["tng_dem"], *out["tng"])
    for r, (a, b) in enumerate(zip(m_j, m_n)):
        assert a.keys() == b.keys(), f"row {r} contact sets differ"
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-10,
                                       err_msg=f"row {r} pair {k}")


def test_native_dem_lvc_3d_trajectory_matches_jax():
    """15 full 3D DEM steps vs the C++ oracle — independent ground
    truth for the 27-stencil engines (all angular components live)."""
    import sys
    sys.path.insert(0, "tests")
    from test_dem_cell import _grain_scene_3d

    from rigid_body_2d_3d_pysph_tpu.native import dem_lvc_step_n

    scheme, scene = _grain_scene_3d(seed=13)
    scheme.engine = "nklist"
    step = scheme.make_step(scene)
    dt = 1e-5
    s = scene
    for _ in range(15):
        s = step(s, jnp.asarray(dt))

    mob = np.zeros(scene.n, bool)
    g = scene.meta.group("grains")
    mob[g.start:g.stop] = True
    out = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz,
                         dt, 15)
    for k in ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz",
              "fx", "fy", "fz", "torx", "tory", "torz"):
        np.testing.assert_allclose(out[k], np.asarray(s[k]), atol=1e-10,
                                   err_msg=k)


def test_native_gtvf_trajectory_matches_cell_engine():
    """The independent C++ oracle vs the JAX step on the CELL engine
    (the GPU default): 60 GTVF steps of the two-cube + wall scene, f64."""
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        RigidBody2DScheme,
    )
    from rigid_body_2d_3d_pysph_tpu.native import gtvf_step_n

    dx = 0.05
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-10, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    body = make_group("body", x, y, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_BOUNDARY,
                      dem_id=2)
    scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                        spacing0=dx)
    scheme = RigidBody2DScheme(rigid_bodies=["body"], boundaries=["wall"],
                               gy=-9.81, dim=2)
    scheme.engine = "cell"
    scene = scheme.setup(scene)
    scene = scheme.set_linear_velocity(
        scene, np.array([[0.3, 0.0, 0.0], [-0.3, 0.0, 0.0]]))

    dt, n_steps = 1e-4, 60
    native = gtvf_step_n(scene, kr=scheme.kr, kf=scheme.kf,
                         fric_coeff=scheme.fric_coeff, gx=0.0, gy=-9.81,
                         gz=0.0, dt=dt, n_steps=n_steps, two_d=True)
    step = scheme.make_step(scene)
    s = scene
    for _ in range(n_steps):
        s = step(s, jnp.asarray(dt))
    assert not bool(np.asarray(s.nbr_overflow))
    assert int((np.asarray(s.overlap) > 0).sum()) > 0
    np.testing.assert_allclose(native["xcm"], np.asarray(s.xcm), atol=1e-8)
    np.testing.assert_allclose(native["vcm"], np.asarray(s.vcm), atol=1e-7)
    np.testing.assert_allclose(native["omega"], np.asarray(s.omega),
                               atol=1e-6)
    np.testing.assert_allclose(native["x"], np.asarray(s.x), atol=1e-8)
    np.testing.assert_allclose(native["u"], np.asarray(s.u), atol=1e-7)
    np.testing.assert_allclose(native["fx"], np.asarray(s.fx), rtol=1e-8,
                               atol=1e-6)
    np.testing.assert_allclose(native["fy"], np.asarray(s.fy), rtol=1e-8,
                               atol=1e-6)


def test_native_dem_lvc_3d_matches_cell_engine():
    """15 full 3D DEM steps vs the C++ oracle on the CELL engine (the
    27-stencil dense path the GPU runs by default)."""
    import sys
    sys.path.insert(0, "tests")
    from test_dem_cell import _grain_scene_3d

    from rigid_body_2d_3d_pysph_tpu.native import dem_lvc_step_n

    scheme, scene = _grain_scene_3d(seed=13)
    scheme.engine = "cell"
    step = scheme.make_step(scene)
    dt = 1e-5
    s = scene
    for _ in range(15):
        s = step(s, jnp.asarray(dt))
    assert not bool(np.asarray(s.nbr_overflow))
    assert int(np.asarray(s.total_tng_contacts).sum()) > 0

    mob = np.zeros(scene.n, bool)
    g = scene.meta.group("grains")
    mob[g.start:g.stop] = True
    out = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz,
                         dt, 15)
    for k in ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz",
              "fx", "fy", "fz", "torx", "tory", "torz"):
        np.testing.assert_allclose(out[k], np.asarray(s[k]), atol=1e-10,
                                   err_msg=k)

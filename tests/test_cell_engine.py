"""Dense cell-block engine vs the [N, K] neighbor-list path: identical
contact pipeline results and identical integrator steps."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
    RigidBody2DScheme, _attach_contact_fields,
)
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as cellmod
from rigid_body_2d_3d_pysph_tpu.ops import contact as cops
from rigid_body_2d_3d_pysph_tpu.ops import contact_cell as ccops
from rigid_body_2d_3d_pysph_tpu.ops import neighbors as nbmod
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY,
)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as rs


def _scene():
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
    scene = build_scene([body, wall], dim=2, total_no_bodies=3, spacing0=dx)
    scene = rs.setup_body_state(scene)
    scene = _attach_contact_fields(scene)
    rng = np.random.default_rng(5)
    n = scene.n
    scene = scene.replace(
        contact_force_is_boundary=jnp.ones(n, scene.x.dtype),
        u=jnp.asarray(rng.uniform(-1, 1, n), scene.x.dtype),
        v=jnp.asarray(rng.uniform(-1, 1, n), scene.x.dtype),
    )
    return scene, dx


def test_cell_pipeline_matches_nklist():
    scene, dx = _scene()
    kernel = QuinticSpline(dim=2)
    cutoff = 3 * 1.3 * dx

    cell_cfg = cellmod.config_from_positions(
        np.asarray(scene.x), np.asarray(scene.y), np.asarray(scene.z),
        cutoff, 2, cell_chunk=16)

    @jax.jit
    def run_cell(scene):
        grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                       scene.active, cell_cfg)
        return grid.overflow, ccops.contact_pipeline_cell(
            scene, grid, cell_cfg, kernel)

    ovf, (cx_c, cy_c, cz_c, cw_c, dinfo_c) = run_cell(scene)
    assert not bool(ovf)

    nbrs = nbmod.brute_force_neighbors(scene.x, scene.y, scene.z,
                                       scene.active, cutoff, 160)

    @jax.jit
    def run_nk(scene):
        cx, cy, cz, cw = cops.contact_force_normals(scene, nbrs, kernel)
        dinfo = cops.contact_force_distance(scene, nbrs, kernel, cx, cy, cz)
        return cx, cy, cz, cw, dinfo

    cx, cy, cz, cw, dinfo = run_nk(scene)

    np.testing.assert_allclose(np.asarray(cx_c), np.asarray(cx), atol=1e-11)
    np.testing.assert_allclose(np.asarray(cy_c), np.asarray(cy), atol=1e-11)
    np.testing.assert_allclose(np.asarray(cw_c), np.asarray(cw), atol=1e-11)
    np.testing.assert_allclose(np.asarray(dinfo_c["contact_force_dist"]),
                               np.asarray(dinfo["contact_force_dist"]),
                               atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(dinfo_c["closest_point_dist_to_source"]),
        np.asarray(dinfo["closest_point_dist_to_source"]), atol=1e-11)
    for k in ("x_source", "y_source", "vx_source", "vy_source"):
        np.testing.assert_allclose(np.asarray(dinfo_c[k]),
                                   np.asarray(dinfo[k]), atol=1e-11,
                                   err_msg=k)


def test_fused_pipeline_matches_two_pass():
    """contact_pipeline_cell_fused (one pass over source blocks, one-hot
    closest-point pick) must reproduce the two-pass cell engine exactly."""
    scene, dx = _scene()
    kernel = QuinticSpline(dim=2)
    cutoff = 3 * 1.3 * dx
    cell_cfg = cellmod.config_from_positions(
        np.asarray(scene.x), np.asarray(scene.y), np.asarray(scene.z),
        cutoff, 2, cell_chunk=16)

    @jax.jit
    def run(scene):
        grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                       scene.active, cell_cfg)
        two = ccops.contact_pipeline_cell(scene, grid, cell_cfg, kernel)
        fused = ccops.contact_pipeline_cell_fused(scene, grid, cell_cfg,
                                                  kernel)
        return grid.overflow, two, fused

    ovf, (cx2, cy2, cz2, cw2, d2), (cxf, cyf, czf, cwf, df) = run(scene)
    assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(cxf), np.asarray(cx2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(cyf), np.asarray(cy2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(czf), np.asarray(cz2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(cwf), np.asarray(cw2), atol=1e-12)
    for k in d2:
        np.testing.assert_allclose(np.asarray(df[k]), np.asarray(d2[k]),
                                   atol=1e-12, err_msg=k)


def test_cell_step_matches_nklist_step():
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.25])
    y = np.concatenate([yb, yb]) + 0.1
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), -0.05)
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID, body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=2)

    def build(engine):
        scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                            spacing0=dx)
        scheme = RigidBody2DScheme(rigid_bodies=["body"],
                                   boundaries=["wall"], gy=-9.81, dim=2)
        scheme.engine = engine
        scene = scheme.setup(scene)
        return scheme, scene

    sch_c, sc_c = build("cell")
    sch_n, sc_n = build("nklist")
    step_c = sch_c.make_step(sc_c)
    step_n = sch_n.make_step(sc_n)
    dt = jnp.asarray(1e-4)
    for _ in range(25):
        sc_c = step_c(sc_c, dt)
        sc_n = step_n(sc_n, dt)
    for k in ("x", "y", "u", "v", "fx", "fy"):
        np.testing.assert_allclose(np.asarray(sc_c[k]), np.asarray(sc_n[k]),
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(np.asarray(sc_c.force),
                               np.asarray(sc_n.force), atol=1e-7)


@pytest.mark.slow
def test_verlet_skin_matches_no_skin():
    """skin > 0 (grid reused across steps, rebuilt past the skin/2
    displacement bound) must reproduce the every-step-rebuild
    trajectory: the widened bins only ADD candidates beyond the cutoff,
    which the rij <= cutoff gate discards."""
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)  # wall at rest distance
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID, body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=2)

    def build(skin_factor):
        scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                            spacing0=dx)
        scheme = RigidBody2DScheme(rigid_bodies=["body"],
                                   boundaries=["wall"], gy=-9.81, dim=2)
        scheme.engine = "cell"
        scheme.skin_factor = skin_factor
        scene = scheme.setup(scene)
        return scheme, scene

    sch_0, sc_0 = build(0.0)
    sch_s, sc_s = build(0.3)
    step_0 = sch_0.make_step(sc_0)
    step_s = sch_s.make_step(sc_s)
    dt = jnp.asarray(1e-4)
    # 25 contact-resolving steps: displacements stay far below skin/2,
    # so the skin path reuses its setup-time grid throughout (the
    # skipped-rebuild window) while forces are active from step 1.
    xb0 = np.asarray(sc_s.g_xb)
    for _ in range(25):
        sc_0 = step_0(sc_0, dt)
        sc_s = step_s(sc_s, dt)
    assert np.array_equal(xb0, np.asarray(sc_s.g_xb)), "expected reuse"
    assert not bool(np.asarray(sc_s.nbr_overflow))
    for k in ("x", "y", "u", "v", "fx", "fy"):
        np.testing.assert_allclose(np.asarray(sc_s[k]), np.asarray(sc_0[k]),
                                   atol=1e-9, err_msg=k)

    # displace one body past skin/2: the next step must rebuild (g_xb
    # refreshes) and forces must again match a fresh-grid engine run.
    shift = 0.6 * 0.3 * (3 * 1.3 * dx)  # > skin/2
    nb1 = len(xb)
    move = np.zeros_like(np.asarray(sc_s.x))
    move[:nb1] = shift
    sc_s = sc_s.replace(x=sc_s.x + jnp.asarray(move, sc_s.x.dtype))
    sc_0 = sc_0.replace(x=sc_0.x + jnp.asarray(move, sc_0.x.dtype))
    sc_s = step_s(sc_s, dt)
    sc_0 = step_0(sc_0, dt)
    assert not np.array_equal(xb0, np.asarray(sc_s.g_xb)), \
        "expected a rebuild"
    assert not bool(np.asarray(sc_s.nbr_overflow))
    for k in ("x", "y", "fx", "fy"):
        np.testing.assert_allclose(np.asarray(sc_s[k]), np.asarray(sc_0[k]),
                                   atol=1e-9, err_msg=k)


def test_boundary_identification_engines_agree():
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        run_boundary_identification, run_boundary_identification_cell,
    )
    from rigid_body_2d_3d_pysph_tpu.ops import neighbors as nb2
    from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as rs2

    scene, dx = _scene()
    kernel = QuinticSpline(dim=2)
    cutoff = 3 * 1.3 * dx
    names = ["body", "wall"]

    cell_cfg = cellmod.config_from_positions(
        np.asarray(scene.x), np.asarray(scene.y), np.asarray(scene.z),
        cutoff, 2, cell_chunk=16)
    s_cell = run_boundary_identification_cell(scene, kernel, cell_cfg, names)

    m, k = nb2.estimate_capacities(
        np.asarray(scene.x), np.asarray(scene.y), np.asarray(scene.z),
        cutoff, 2)
    nk_cfg = nb2.default_config(2, cutoff, scene.n, max_neighbors=k,
                                max_per_cell=m)
    s_nk = run_boundary_identification(scene, kernel, nk_cfg, names)

    np.testing.assert_array_equal(np.asarray(s_cell.is_boundary),
                                  np.asarray(s_nk.is_boundary))
    np.testing.assert_allclose(np.asarray(s_cell.normal),
                               np.asarray(s_nk.normal), atol=1e-11)


def test_cell_engine_3d_matches_nklist():
    """3D (27-cell stencil) equivalence on a two-cube + floor scene."""
    from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block

    dx = 0.05
    xb, yb, zb = get_3d_block(dx, 0.2, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    z = np.concatenate([zb, zb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    # floor plane below
    fx_, fz_ = np.meshgrid(np.arange(-6, 14) * dx, np.arange(-6, 7) * dx)
    fy_ = np.full(fx_.size, y.min() - 0.7 * dx)
    body = make_group("body", x, y, z, m=2000 * dx**3, h=1.2 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=bid, dem_id=bid)
    wall = make_group("wall", fx_.ravel(), fy_, fz_.ravel(),
                      m=2000 * dx**3, h=1.2 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=2)
    scene = build_scene([body, wall], dim=3, total_no_bodies=3, spacing0=dx)
    scene = rs.setup_body_state(scene)
    scene = _attach_contact_fields(scene)
    rng = np.random.default_rng(11)
    n = scene.n
    scene = scene.replace(
        contact_force_is_boundary=jnp.ones(n, scene.x.dtype),
        u=jnp.asarray(rng.uniform(-1, 1, n), scene.x.dtype),
        w=jnp.asarray(rng.uniform(-1, 1, n), scene.x.dtype),
    )
    kernel = QuinticSpline(dim=3)
    cutoff = 3 * 1.2 * dx
    cell_cfg = cellmod.config_from_positions(
        np.asarray(scene.x), np.asarray(scene.y), np.asarray(scene.z),
        cutoff, 3, cell_chunk=64)

    @jax.jit
    def run_cell(scene):
        grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                       scene.active, cell_cfg)
        return grid.overflow, ccops.contact_pipeline_cell(
            scene, grid, cell_cfg, kernel)

    ovf, (cx_c, cy_c, cz_c, cw_c, dinfo_c) = run_cell(scene)
    assert not bool(ovf)

    nbrs = nbmod.brute_force_neighbors(scene.x, scene.y, scene.z,
                                       scene.active, cutoff, 256)

    @jax.jit
    def run_nk(scene):
        cx, cy, cz, cw = cops.contact_force_normals(scene, nbrs, kernel)
        dinfo = cops.contact_force_distance(scene, nbrs, kernel, cx, cy, cz)
        return cx, cy, cz, cw, dinfo

    cx, cy, cz, cw, dinfo = run_nk(scene)
    np.testing.assert_allclose(np.asarray(cx_c), np.asarray(cx), atol=1e-11)
    np.testing.assert_allclose(np.asarray(cz_c), np.asarray(cz), atol=1e-11)
    np.testing.assert_allclose(np.asarray(cw_c), np.asarray(cw), atol=1e-11)
    np.testing.assert_allclose(np.asarray(dinfo_c["contact_force_dist"]),
                               np.asarray(dinfo["contact_force_dist"]),
                               atol=1e-11)
    for k in ("x_source", "z_source", "vx_source", "vz_source"):
        np.testing.assert_allclose(np.asarray(dinfo_c[k]),
                                   np.asarray(dinfo[k]), atol=1e-11,
                                   err_msg=k)


def test_rk2_and_leapfrog_cell_match_nklist():
    """RK2 (2D) + leapfrog (3D free body) on the cell engine must match
    the nklist engine — integrator="rk2" no longer silently drops to the
    [N,K] path (round-2 VERDICT item 2)."""
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.25])
    y = np.concatenate([yb, yb]) + 0.1
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), -0.05)
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID, body_id=bid,
                      dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=2)

    def build(engine):
        scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                            spacing0=dx)
        scheme = RigidBody2DScheme(rigid_bodies=["body"],
                                   boundaries=["wall"], gy=-9.81, dim=2)
        scheme.engine = engine
        scheme.integrator = "rk2"
        scene = scheme.setup(scene)
        return scheme, scene

    sch_c, sc_c = build("cell")
    sch_n, sc_n = build("nklist")
    step_c = sch_c.make_step(sc_c)
    step_n = sch_n.make_step(sc_n)
    dt = jnp.asarray(1e-4)
    for _ in range(20):
        sc_c = step_c(sc_c, dt)
        sc_n = step_n(sc_n, dt)
    assert not bool(np.asarray(sc_c.nbr_overflow))
    for k in ("x", "y", "u", "v", "fx", "fy"):
        np.testing.assert_allclose(np.asarray(sc_c[k]), np.asarray(sc_n[k]),
                                   atol=1e-9, err_msg="rk2 " + k)

    # leapfrog: 3D free tumbling body (no contacts needed to exercise
    # the engine routing)
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        RigidBody3DScheme,
    )
    from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block

    x3, y3, z3 = get_3d_block(dx, 0.2, 0.12, 0.16)

    def build3(engine):
        grp = make_group("body", x3, y3, z3, m=m, h=1.3 * dx, rho=2000.0,
                         rad_s=dx / 2, role=ROLE_RIGID,
                         body_id=np.zeros(len(x3), np.int32),
                         dem_id=np.zeros(len(x3), np.int32))
        scene = build_scene([grp], dim=3, total_no_bodies=1, spacing0=dx)
        scheme = RigidBody3DScheme(rigid_bodies=["body"], boundaries=[],
                                   dim=3)
        scheme.engine = engine
        scheme.integrator = "leapfrog"
        if engine == "cell":
            # small cell chunks: the 27-cell 3D stencil at quintic
            # occupancy (~60/cell, M=96) makes [C, M, O*M] f64
            # intermediates ~1 GB at the default 512-cell chunk on CPU
            scheme._cell_cfg = cellmod.config_from_positions(
                x3, y3, z3, 3 * 1.3 * dx, 3, cell_chunk=4)
        scene = scheme.setup(scene)
        scene = scheme.set_linear_velocity(scene, [1.0, 0.5, 0.25])
        scene = scheme.set_angular_velocity(scene, [0.5, 1.5, 0.25])
        return scheme, scene

    sch3c, sc3c = build3("cell")
    sch3n, sc3n = build3("nklist")
    st3c = sch3c.make_step(sc3c)
    st3n = sch3n.make_step(sc3n)
    for _ in range(5):
        sc3c = st3c(sc3c, dt)
        sc3n = st3n(sc3n, dt)
    for k in ("x", "y", "z", "u", "v", "w"):
        np.testing.assert_allclose(np.asarray(sc3c[k]),
                                   np.asarray(sc3n[k]), atol=1e-9,
                                   err_msg="leapfrog " + k)


def test_cell_engine_3d_step_matches_nklist():
    """Full 3D GTVF steps (27-cell stencil, body rotation live) on the
    cell engine vs the [N,K] engine: same trajectory."""
    from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block
    from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
        RigidBody3DScheme,
    )

    dx = 0.05
    xb, yb, zb = get_3d_block(dx, 0.2, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.9 * dx])
    y = np.concatenate([yb, yb + 0.5 * dx])
    z = np.concatenate([zb, zb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    # a 3-layer floor slab (a single layer has no outward normal)
    fx_, fz_ = np.meshgrid(np.arange(-6, 14) * dx, np.arange(-6, 7) * dx)
    fx_, fz_ = np.tile(fx_.ravel(), 3), np.tile(fz_.ravel(), 3)
    fy_ = np.repeat(y.min() - 0.9 * dx - dx * np.arange(3), fx_.size // 3)
    m = 2000 * dx**3

    def build(engine):
        body = make_group("body", x, y, z, m=m, h=1.2 * dx, rho=2000.0,
                          rad_s=dx / 2, role=ROLE_RIGID, body_id=bid,
                          dem_id=bid)
        wall = make_group("wall", fx_, fy_, fz_, m=m,
                          h=1.2 * dx, rho=2000.0, rad_s=dx / 2,
                          role=ROLE_BOUNDARY, dem_id=2)
        scene = build_scene([body, wall], dim=3, total_no_bodies=3,
                            spacing0=dx)
        scheme = RigidBody3DScheme(rigid_bodies=["body"],
                                   boundaries=["wall"], gy=-9.81, dim=3)
        scheme.engine = engine
        if engine == "cell":
            # small cell chunks keep the [C, M, O*M] f64 blocks small
            scheme._cell_cfg = cellmod.config_from_positions(
                np.concatenate([x, fx_]), np.concatenate([y, fy_]),
                np.concatenate([z, fz_]), 3 * 1.2 * dx, 3, cell_chunk=16)
        scene = scheme.setup(scene)
        scene = scheme.set_angular_velocity(
            scene, np.array([[0.3, -0.2, 0.5], [-0.4, 0.1, 0.2]]))
        return scheme, scene

    sch_c, s_c = build("cell")
    sch_n, s_n = build("nklist")
    step_c, step_n = sch_c.make_step(s_c), sch_n.make_step(s_n)
    dt = jnp.asarray(5e-5)
    for _ in range(10):
        s_c, s_n = step_c(s_c, dt), step_n(s_n, dt)
    assert not bool(np.asarray(s_c.nbr_overflow))
    assert int((np.asarray(s_n.overlap) > 0).sum()) > 0
    for k in ("x", "y", "z", "u", "v", "w", "fx", "fy", "fz"):
        np.testing.assert_allclose(np.asarray(s_c[k]), np.asarray(s_n[k]),
                                   atol=1e-9, err_msg=k)
    for k in ("xcm", "vcm", "omega", "R"):
        np.testing.assert_allclose(np.asarray(s_c[k]), np.asarray(s_n[k]),
                                   atol=1e-10, err_msg=k)

"""Rigid-body schemes (3D rotation-matrix dynamics; 2D scalar-inertia
specialization) with the GTVF kick-drift-kick integrator.

Re-design of the reference's ``RigidBody3DScheme``
(``code/rigid_body_3d.py:578-949``) and ``RigidBody2DScheme``
(``code/rigid_body_2d.py:208-601``).  One timestep is ONE fused jitted
device program implementing PySPH's GTVF sequence
(``pysph.sph.wc.gtvf.GTVFIntegrator``; stage trace in SURVEY.md §3.3):

    stage-1 eqs (none) -> stepper stage1 -> stage-2 eqs (contact
    pipeline) -> stepper stage2 -> stepper stage3

with the reference's host-Python per-body ``py_stageN`` loops
(``rigid_body_3d.py:41-60,97-132,171-190``) replaced by batched [B,3,3]
linear algebra on device, and the host-serial force/torque reduce
(``rigid_body_common.py:128-175``) by ``segment_sum``.

Force convention (parity-critical): the first half-kick of step n uses
the force computed during step n-1's stage-2 evaluation (PySPH evaluates
stage-1 equations — an empty set here — without touching the force
arrays), the second half-kick uses the freshly evaluated force.  Body
force/torque therefore persist in the Scene between steps.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import boundary as bops
from ..ops import cellpairs as cellmod
from ..ops import contact as cops
from ..ops import contact_cell as ccops
from ..ops import rigid as rops

# Every body-math einsum runs at HIGHEST precision: at DEFAULT, XLA:GPU
# may run f32 matrix products in TF32 (a 10-bit mantissa), which rounds
# O(1) rotation and inertia products at ~1e-3.  B is tiny, so exact f32
# costs nothing.
_PREC_EXACT = jax.lax.Precision.HIGHEST
from ..ops import neighbors as nbmod
from ..ops.kernels import get_kernel
from ..state import rigid_setup
from ..state.scene import Scene
from .base import Scheme

# [N, S] contact-slot state attached by setup (reference strided props,
# ``rigid_body_3d.py:739-771``).  *_tmp accumulators of the reference are
# transient inside the fused step and need no storage.
SLOT_FIELDS = (
    "contact_force_normal_x", "contact_force_normal_y",
    "contact_force_normal_z", "contact_force_normal_wij",
    "contact_force_dist", "overlap",
    "ft_x", "ft_y", "ft_z",
    "fn_x", "fn_y", "fn_z",
    "delta_lt_x", "delta_lt_y", "delta_lt_z",
    "vx_source", "vy_source", "vz_source",
    "x_source", "y_source", "z_source",
    "ti_x", "ti_y", "ti_z",
    "closest_point_dist_to_source",
)


def _attach_contact_fields(scene: Scene) -> Scene:
    fdt = config.float_dtype()
    n, S = scene.n, scene.meta.total_no_bodies
    fields = {k: jnp.zeros((n, S), fdt) for k in SLOT_FIELDS
              if k not in scene}
    if "normal" not in scene:
        fields["normal"] = jnp.zeros((n, 3), fdt)
        fields["normal0"] = jnp.zeros((n, 3), fdt)
        fields["is_boundary"] = jnp.zeros(n, jnp.int32)
    if "contact_force_is_boundary" not in scene:
        fields["contact_force_is_boundary"] = jnp.zeros(n, fdt)
    if "nbr_overflow" not in scene:
        fields["nbr_overflow"] = jnp.zeros((), bool)
    return scene.with_fields(**fields)


def run_boundary_identification_cell(scene: Scene, kernel, cell_cfg,
                                     group_names: Sequence[str]) -> Scene:
    """Setup-time surface identification on the dense cell engine (all
    groups in one 3-pass program; each group identifies against itself)."""
    from ..ops import boundary_cell as bcops

    sel = np.full(scene.n, -1.0)
    for gi, name in enumerate(group_names):
        g = scene.meta.group(name)
        sel[g.start:g.stop] = float(gi)
    sel = jnp.asarray(sel, config.float_dtype())

    @jax.jit
    def _identify(scene, sel):
        grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                       scene.active, cell_cfg)
        n, isb = bcops.boundary_identification_cell(scene, grid, cell_cfg,
                                                    kernel, sel)
        return n, isb, grid.overflow

    normal, isb, ovf = _identify(scene, sel)
    if bool(np.asarray(ovf)):
        raise RuntimeError("cell-grid overflow during boundary "
                           "identification — increase grid capacity")
    mask = np.asarray(sel) >= 0
    normal = jnp.where(jnp.asarray(mask)[:, None], normal, scene.normal)
    isb = jnp.where(jnp.asarray(mask), isb, scene.is_boundary)
    return scene.replace(normal=normal, normal0=normal, is_boundary=isb)


def run_boundary_identification(scene: Scene, kernel,
                                cfg: nbmod.NeighborConfig,
                                group_names: Sequence[str]) -> Scene:
    """One-shot surface identification per named group (the reference's
    setup-time ``SPHEvaluator`` pass, ``rigid_body_3d.py:860-903``; each
    group identifies against itself).  All groups are processed inside a
    single jitted program (compiles are expensive on this platform)."""
    bounds = tuple((scene.meta.group(n).start, scene.meta.group(n).stop)
                   for n in group_names)

    @jax.jit
    def _identify(scene):
        nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                     scene.active, cfg)
        normal = scene.normal
        isb = scene.is_boundary
        idx = jnp.arange(scene.n)
        for (s, e) in bounds:  # static unroll over groups
            mask = (idx >= s) & (idx < e)
            n_g, b_g = bops.boundary_identification(scene, nbrs, kernel,
                                                    mask, mask)
            normal = jnp.where(mask[:, None], n_g, normal)
            isb = jnp.where(mask, b_g, isb)
        return normal, isb

    normal, isb = _identify(scene)
    return scene.replace(normal=normal, normal0=normal, is_boundary=isb)


class _RigidBodySchemeBase(Scheme):
    two_d = False

    def __init__(self, rigid_bodies, boundaries, dim, kr=1e5, kf=1e5,
                 en=0.5, fric_coeff=0.5, gx=0.0, gy=0.0, gz=0.0):
        self.rigid_bodies = list(rigid_bodies or [])
        self.boundaries = list(boundaries or [])
        self.dim = dim
        self.kr = kr
        self.kf = kf
        self.en = en
        self.fric_coeff = fric_coeff
        self.gx, self.gy, self.gz = gx, gy, gz
        self.kernel_name = "quintic"
        self.integrator = "gtvf"  # or "rk2" (reference RK2RigidBody3DStep)
        # Verlet skin as a fraction of the cutoff: > 0 widens the bins by
        # skin and rebuilds the grid only when some particle has moved
        # more than skin/2 since the last build.
        self.skin_factor = 0.0
        self.dt = None
        self.tf = None
        self.pfreq = 100
        self._nbr_cfg: Optional[nbmod.NeighborConfig] = None
        self._cell_cfg: Optional[cellmod.CellGridConfig] = None

    # CLI parity with reference (:609-631)
    def add_user_options(self, group):
        group.add_argument("--kr-stiffness", dest="kr", default=1e5,
                           type=float, help="Repulsive spring stiffness")
        group.add_argument("--kf-stiffness", dest="kf", default=1e3,
                           type=float, help="Tangential spring stiffness")
        group.add_argument("--fric-coeff", dest="fric_coeff", default=0.5,
                           type=float, help="Friction coefficient")

    def consume_user_options(self, options):
        for k in ("kr", "kf", "fric_coeff"):
            if hasattr(options, k):
                setattr(self, k, getattr(options, k))

    # -- setup ------------------------------------------------------------
    def setup(self, scene: Scene, coeff_of_rest=None,
              identify_boundaries: bool = True) -> Scene:
        scene = _attach_contact_fields(scene)
        scene = rigid_setup.setup_body_state(scene, coeff_of_rest)
        kernel = get_kernel(self.kernel_name, self.dim)
        if identify_boundaries:
            names = self.rigid_bodies + self.boundaries
            if self.engine == "cell":
                scene = run_boundary_identification_cell(
                    scene, kernel, self.cell_config(scene, kernel), names)
            else:
                self._nbr_cfg = self.neighbor_config(scene,
                                                     kernel.radius_scale)
                scene = run_boundary_identification(
                    scene, kernel, self._nbr_cfg, names)
            # host-side cast (avoid a device round-trip compile)
            cfib = np.asarray(scene.is_boundary).astype(np.float64)
            scene = scene.replace(
                contact_force_is_boundary=jnp.asarray(
                    cfib, config.float_dtype()))
        if self.engine == "cell" and self.skin_factor > 0:
            scene = attach_grid_fields(scene,
                                       self.cell_config(scene, kernel))
        return scene

    def set_linear_velocity(self, scene, vel):
        return rigid_setup.set_linear_velocity(scene, vel)

    def set_angular_velocity(self, scene, omega):
        return rigid_setup.set_angular_velocity(scene, omega)

    def cell_config(self, scene: Scene, kernel) -> cellmod.CellGridConfig:
        if self._cell_cfg is None:
            cutoff = float(kernel.radius_scale * np.asarray(scene.h).max())
            self._cell_cfg = cellmod.config_from_positions(
                np.asarray(scene.x), np.asarray(scene.y),
                np.asarray(scene.z), cutoff, self.dim,
                skin=self.skin_factor * cutoff,
                capacity_boost=self.capacity_boost)
        return self._cell_cfg

    # -- the fused step ---------------------------------------------------
    def make_step(self, scene: Scene):
        kernel = get_kernel(self.kernel_name, self.dim)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        use_cell = self.engine == "cell"
        cell_cfg = self.cell_config(scene, kernel) if use_cell else None
        if not use_cell and self._nbr_cfg is None:
            self._nbr_cfg = self.neighbor_config(scene, kernel.radius_scale)
        if getattr(self, "integrator", "gtvf") == "rk2":
            return build_rigid_rk2_step(kernel, self._nbr_cfg, params,
                                        self.two_d, cell_cfg=cell_cfg)
        if getattr(self, "integrator", "gtvf") == "leapfrog":
            if self.two_d:
                raise ValueError("leapfrog stepper is 3D-only "
                                 "(reference rigid_body_3d.py:228)")
            return build_rigid_leapfrog_step(kernel, self._nbr_cfg, params,
                                             cell_cfg=cell_cfg)
        if use_cell:
            return build_rigid_gtvf_step_cell(kernel, cell_cfg, params,
                                              self.two_d)
        return build_rigid_gtvf_step(kernel, self._nbr_cfg, params,
                                     self.two_d)


class RigidBody3DScheme(_RigidBodySchemeBase):
    name = "rb3d"
    two_d = False


class RigidBody2DScheme(_RigidBodySchemeBase):
    name = "rb2d"
    two_d = True


# ---------------------------------------------------------------------------
# step construction
# ---------------------------------------------------------------------------

def _body_half_kick(scene, dt, two_d):
    """Stepper py_stage1/py_stage3 (3D ``rigid_body_3d.py:41-60``; 2D
    ``rigid_body_2d.py:41-55`` updates only x/y and omega_z via izz)."""
    M = scene.total_mass[:, None]
    if two_d:
        vcm = scene.vcm.at[:, :2].add(0.5 * dt * scene.force[:, :2] / M)
        izz = jnp.where(scene.izz > 0, scene.izz, 1.0)
        omega = scene.omega.at[:, 2].add(0.5 * dt * scene.torque[:, 2] / izz)
        return scene.replace(vcm=vcm, omega=omega)
    vcm = scene.vcm + 0.5 * dt * scene.force / M
    ang_mom = scene.ang_mom + 0.5 * dt * scene.torque
    omega = jnp.einsum("bij,bj->bi",
                       scene.inertia_tensor_inverse_global_frame, ang_mom,
                       precision=_PREC_EXACT)
    return scene.replace(vcm=vcm, ang_mom=ang_mom, omega=omega)


def _body_drift(scene, dt, two_d):
    """Stepper py_stage2: advance COM + orientation (3D
    ``rigid_body_3d.py:97-132``; 2D ``rigid_body_2d.py:92-118`` skips the
    inertia update and z drift)."""
    if two_d:
        xcm = scene.xcm.at[:, :2].add(dt * scene.vcm[:, :2])
    else:
        xcm = scene.xcm + dt * scene.vcm
    Om = rops.omega_cross_matrix(scene.omega)
    R = scene.R + dt * jnp.einsum("bij,bjk->bik", Om, scene.R,
                                  precision=_PREC_EXACT)
    R = rops.gram_schmidt_columns(R)
    out = dict(xcm=xcm, R=R)
    if not two_d:
        out["inertia_tensor_inverse_global_frame"] = jnp.einsum(
            "bij,bjk,blk->bil", R,
            scene.inertia_tensor_inverse_body_frame, R,
            precision=_PREC_EXACT)
    return scene.replace(**out)


def _particles_from_body_velocity(scene):
    """Stepper stage1/stage3 per-particle update: u = vcm + omega x (R dr0)
    (``rigid_body_3d.py:62-95``)."""
    rigid = scene.is_rigid
    bid = jnp.where(rigid, scene.body_id, 0)
    dx, dy, dz = rops.rotate_body_frame_vectors(
        scene.R, bid, scene.dx0, scene.dy0, scene.dz0)
    om = rops.gather_body_rows(scene.omega, bid, scene.meta.nb)
    du = om[:, 1] * dz - om[:, 2] * dy
    dv = om[:, 2] * dx - om[:, 0] * dz
    dw = om[:, 0] * dy - om[:, 1] * dx
    vcm = rops.gather_body_rows(scene.vcm, bid, scene.meta.nb)
    return scene.replace(
        u=jnp.where(rigid, vcm[:, 0] + du, scene.u),
        v=jnp.where(rigid, vcm[:, 1] + dv, scene.v),
        w=jnp.where(rigid, vcm[:, 2] + dw, scene.w),
    )


def _particles_from_body_position(scene):
    """Stepper stage2 per-particle update: x = xcm + R dr0, plus rotation
    of stored surface normals (``rigid_body_3d.py:134-169``)."""
    rigid = scene.is_rigid
    bid = jnp.where(rigid, scene.body_id, 0)
    dx, dy, dz = rops.rotate_body_frame_vectors(
        scene.R, bid, scene.dx0, scene.dy0, scene.dz0)
    xcm = rops.gather_body_rows(scene.xcm, bid, scene.meta.nb)
    nx, ny, nz = rops.rotate_body_frame_vectors(
        scene.R, bid, scene.normal0[:, 0], scene.normal0[:, 1],
        scene.normal0[:, 2])
    rot_n = jnp.stack([nx, ny, nz], -1)
    upd_n = (rigid & (scene.is_boundary == 1))[:, None]
    return scene.replace(
        x=jnp.where(rigid, xcm[:, 0] + dx, scene.x),
        y=jnp.where(rigid, xcm[:, 1] + dy, scene.y),
        z=jnp.where(rigid, xcm[:, 2] + dz, scene.z),
        normal=jnp.where(upd_n, rot_n, scene.normal),
    )


def rigid_contact_force_eval(scene, nbrs, kernel, params, dt,
                             extra_force=None):
    """The reference's stage-2 equation groups G1-G6 (SURVEY.md §3.3):
    contact normals -> distance/closest-point -> body force ->
    contact force [-> extra (FSI) force] -> per-body sum-up."""
    cfn_x, cfn_y, cfn_z, cfn_w = cops.contact_force_normals(
        scene, nbrs, kernel)
    dinfo = cops.contact_force_distance(scene, nbrs, kernel,
                                        cfn_x, cfn_y, cfn_z)
    fx, fy, fz = rops.body_force(scene, params["gx"], params["gy"],
                                 params["gz"], scene.is_rigid)
    dfx, dfy, dfz, slots = cops.contact_force(
        scene, dt, params["kr"], params["kf"], params["fric_coeff"],
        cfn_x, cfn_y, cfn_z, dinfo,
        scene.delta_lt_x, scene.delta_lt_y, scene.delta_lt_z,
        scene.fn_x, scene.fn_y, scene.fn_z)
    fx, fy, fz = fx + dfx, fy + dfy, fz + dfz
    if extra_force is not None:
        efx, efy, efz = extra_force(scene, nbrs)
        fx, fy, fz = fx + efx, fy + efy, fz + efz
    force, torque = rops.sum_up_external_forces(scene, fx, fy, fz)
    scene = scene.replace(
        fx=fx, fy=fy, fz=fz, force=force, torque=torque,
        contact_force_normal_x=cfn_x, contact_force_normal_y=cfn_y,
        contact_force_normal_z=cfn_z, contact_force_normal_wij=cfn_w,
        contact_force_dist=dinfo["contact_force_dist"],
        closest_point_dist_to_source=dinfo["closest_point_dist_to_source"],
        x_source=dinfo["x_source"], y_source=dinfo["y_source"],
        z_source=dinfo["z_source"], vx_source=dinfo["vx_source"],
        vy_source=dinfo["vy_source"], vz_source=dinfo["vz_source"],
        **slots,
    )
    return scene


def rigid_contact_force_eval_cell(scene, grid, cell_cfg, kernel, params, dt,
                                  extra_fx=None):
    """Stage-2 equation groups on the dense cell engine (same sequence as
    :func:`rigid_contact_force_eval`)."""
    cfn_x, cfn_y, cfn_z, cfn_w, dinfo = ccops.contact_pipeline_cell_fused(
        scene, grid, cell_cfg, kernel)
    return _contact_force_tail(scene, cfn_x, cfn_y, cfn_z, cfn_w, dinfo,
                               params, dt, extra_fx)


def _contact_force_tail(scene, cfn_x, cfn_y, cfn_z, cfn_w, dinfo,
                        params, dt, extra_fx=None):
    fx, fy, fz = rops.body_force(scene, params["gx"], params["gy"],
                                 params["gz"], scene.is_rigid)
    dfx, dfy, dfz, slots = cops.contact_force(
        scene, dt, params["kr"], params["kf"], params["fric_coeff"],
        cfn_x, cfn_y, cfn_z, dinfo,
        scene.delta_lt_x, scene.delta_lt_y, scene.delta_lt_z,
        scene.fn_x, scene.fn_y, scene.fn_z)
    fx, fy, fz = fx + dfx, fy + dfy, fz + dfz
    if extra_fx is not None:
        efx, efy, efz = extra_fx
        fx, fy, fz = fx + efx, fy + efy, fz + efz
    force, torque = rops.sum_up_external_forces(scene, fx, fy, fz)
    return scene.replace(
        fx=fx, fy=fy, fz=fz, force=force, torque=torque,
        contact_force_normal_x=cfn_x, contact_force_normal_y=cfn_y,
        contact_force_normal_z=cfn_z, contact_force_normal_wij=cfn_w,
        contact_force_dist=dinfo["contact_force_dist"],
        closest_point_dist_to_source=dinfo["closest_point_dist_to_source"],
        x_source=dinfo["x_source"], y_source=dinfo["y_source"],
        z_source=dinfo["z_source"], vx_source=dinfo["vx_source"],
        vy_source=dinfo["vy_source"], vz_source=dinfo["vz_source"],
        **slots,
    )


def attach_grid_fields(scene: Scene, cell_cfg) -> Scene:
    """Verlet-skin support: carry the cell grid + build-time positions in
    the Scene so the step can skip rebuilds while displacements stay
    under skin/2."""
    grid = jax.jit(lambda s: cellmod.build_cell_grid(
        s.x, s.y, s.z, s.active, cell_cfg))(scene)
    return scene.with_fields(
        g_slot2p=grid.slot2p, g_dense_pos=grid.dense_pos,
        g_nbr_slots=grid.nbr_slots, g_n_occ=grid.n_occupied,
        g_overflow=grid.overflow,
        g_xb=scene.x, g_yb=scene.y, g_zb=scene.z)


def _grid_for_step(scene: Scene, cell_cfg):
    """Current grid for the force evaluation: a fresh build (skin == 0)
    or the carried grid, rebuilt only past the skin/2 displacement bound
    (``lax.cond`` — both branches compiled once)."""
    if cell_cfg.skin <= 0.0:
        grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                       scene.active, cell_cfg)
        return scene, grid

    d2 = ((scene.x - scene.g_xb) ** 2 + (scene.y - scene.g_yb) ** 2
          + (scene.z - scene.g_zb) ** 2)
    max_d2 = jnp.max(jnp.where(scene.active, d2, 0.0))
    need = max_d2 > (0.5 * cell_cfg.skin) ** 2

    def rebuild(s):
        g = cellmod.build_cell_grid(s.x, s.y, s.z, s.active, cell_cfg)
        return s.replace(g_slot2p=g.slot2p, g_dense_pos=g.dense_pos,
                         g_nbr_slots=g.nbr_slots, g_n_occ=g.n_occupied,
                         g_overflow=g.overflow, g_xb=s.x, g_yb=s.y,
                         g_zb=s.z)

    scene = jax.lax.cond(need, rebuild, lambda s: s, scene)
    grid = cellmod.CellGrid(
        slot2p=scene.g_slot2p, dense_pos=scene.g_dense_pos,
        nbr_slots=scene.g_nbr_slots, n_occupied=scene.g_n_occ,
        overflow=scene.g_overflow)
    return scene, grid


def build_rigid_gtvf_step_cell(kernel, cell_cfg, params: dict, two_d: bool):
    """GTVF timestep on the dense cell engine."""

    @jax.jit
    def step(scene: Scene, dt):
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)

        scene, grid = _grid_for_step(scene, cell_cfg)
        scene = rigid_contact_force_eval_cell(scene, grid, cell_cfg, kernel,
                                              params, dt)
        scene = scene.replace(nbr_overflow=scene.nbr_overflow | grid.overflow)

        scene = _body_drift(scene, dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)
        return scene

    return step


def build_rigid_gtvf_step(kernel, cfg: nbmod.NeighborConfig, params: dict,
                          two_d: bool):
    """One full GTVF timestep for the rigid-only schemes, jitted."""

    @jax.jit
    def step(scene: Scene, dt):
        # stage-1 equations: none.  Stepper stage 1 (kick w/ stored force)
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)

        # stage-2 equations (with NNPS refresh, as PySPH's
        # compute_accelerations(1, update_nnps=True))
        nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                     scene.active, cfg)
        scene = rigid_contact_force_eval(scene, nbrs, kernel, params, dt)
        scene = scene.replace(nbr_overflow=scene.nbr_overflow | nbrs.overflow)

        # stepper stage 2 (drift) then stage 3 (kick w/ fresh force)
        scene = _body_drift(scene, dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)
        return scene

    return step


def _make_force_eval(kernel, params, nbr_cfg=None, cell_cfg=None):
    """Engine-agnostic stage-2 force evaluation: (scene, dt) -> scene
    with forces + overflow flag folded in.  Cell engine when
    ``cell_cfg`` is given, [N,K] lists otherwise — lets every stepper
    (GTVF/RK2/leapfrog) ride either pair engine."""
    if cell_cfg is not None:
        def ev(scene, dt):
            scene, grid = _grid_for_step(scene, cell_cfg)
            scene = rigid_contact_force_eval_cell(
                scene, grid, cell_cfg, kernel, params, dt)
            return scene.replace(
                nbr_overflow=scene.nbr_overflow | grid.overflow)
    else:
        def ev(scene, dt):
            nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                         scene.active, nbr_cfg)
            scene = rigid_contact_force_eval(scene, nbrs, kernel, params,
                                             dt)
            return scene.replace(
                nbr_overflow=scene.nbr_overflow | nbrs.overflow)
    return ev


def _rk2_body_stage(scene, frac_dt, two_d):
    """RK2 predictor/corrector body update from the saved t=0 state
    (reference ``RK2RigidBody3DStep.py_stage1/py_stage2``,
    ``rigid_body_3d.py:424-463,502-538``): positions/velocities advance
    from the *saved* state using current derivatives; R integrates from
    R0 with the current omega.  NOTE: the reference's ``py_initialize``
    saves ang_mom0 with a per-body indexing slip (:415, writes only
    ``ang_mom0[0:3]``); we save it per body — the intended semantics."""
    M = scene.total_mass[:, None]
    if two_d:
        vcm = scene.vcm0.at[:, :2].set(
            scene.vcm0[:, :2] + frac_dt * scene.force[:, :2] / M)
        xcm = scene.xcm0.at[:, :2].set(
            scene.xcm0[:, :2] + frac_dt * scene.vcm[:, :2])
    else:
        vcm = scene.vcm0 + frac_dt * scene.force / M
        xcm = scene.xcm0 + frac_dt * scene.vcm
    Om = rops.omega_cross_matrix(scene.omega)
    R = scene.R0 + frac_dt * jnp.einsum("bij,bjk->bik", Om, scene.R,
                                        precision=_PREC_EXACT)
    R = rops.gram_schmidt_columns(R)
    out = dict(xcm=xcm, vcm=vcm, R=R)
    if two_d:
        izz = jnp.where(scene.izz > 0, scene.izz, 1.0)
        out["omega"] = scene.omega0.at[:, 2].set(
            scene.omega0[:, 2] + frac_dt * scene.torque[:, 2] / izz)
    else:
        Iinv = jnp.einsum("bij,bjk,blk->bil", R,
                          scene.inertia_tensor_inverse_body_frame, R,
                          precision=_PREC_EXACT)
        ang_mom = scene.ang_mom0 + frac_dt * scene.torque
        out["inertia_tensor_inverse_global_frame"] = Iinv
        out["ang_mom"] = ang_mom
        out["omega"] = jnp.einsum("bij,bj->bi", Iinv, ang_mom,
                                  precision=_PREC_EXACT)
    return scene.replace(**out)


def build_rigid_rk2_step(kernel, cfg, params: dict, two_d: bool,
                         cell_cfg=None):
    """Predict-evaluate-correct RK2 timestep (reference
    ``RK2RigidBody3DStep`` wired through an EPEC-style sequence).
    Runs on the cell engine when ``cell_cfg`` is given."""
    force_eval = _make_force_eval(kernel, params, nbr_cfg=cfg,
                                  cell_cfg=cell_cfg)

    @jax.jit
    def step(scene: Scene, dt):
        scene = scene.replace(xcm0=scene.xcm, vcm0=scene.vcm,
                              ang_mom0=scene.ang_mom, omega0=scene.omega,
                              R0=scene.R)
        # predictor: eval forces at t, advance half step
        scene = force_eval(scene, dt)
        scene = _rk2_body_stage(scene, 0.5 * dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _particles_from_body_velocity(scene)
        # corrector: re-eval at midpoint, advance full step from saved
        scene = force_eval(scene, dt)
        scene = _rk2_body_stage(scene, dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _particles_from_body_velocity(scene)
        return scene

    return step


def _leapfrog_body_stage(scene, frac_dt):
    """Reference ``LeapFrogRigidBody3DStep`` body update
    (``rigid_body_3d.py:228-405``; marked FIXME and unused there — ported
    for API completeness): positions advance from the saved state with
    the PRE-update velocity, velocities with the current force; R
    integrates from R0 with the current omega.  As with RK2, the
    reference's ``py_initialize`` saves ``ang_mom0`` only for body 0
    (:243-244); we save it per body — the intended semantics."""
    M = scene.total_mass[:, None]
    xcm = scene.xcm0 + frac_dt * scene.vcm
    vcm = scene.vcm0 + frac_dt * scene.force / M
    Om = rops.omega_cross_matrix(scene.omega)
    R = rops.gram_schmidt_columns(
        scene.R0 + frac_dt * jnp.einsum("bij,bjk->bik", Om, scene.R,
                                        precision=_PREC_EXACT))
    Iinv = jnp.einsum("bij,bjk,blk->bil", R,
                      scene.inertia_tensor_inverse_body_frame, R,
                      precision=_PREC_EXACT)
    ang_mom = scene.ang_mom0 + frac_dt * scene.torque
    omega = jnp.einsum("bij,bj->bi", Iinv, ang_mom, precision=_PREC_EXACT)
    return scene.replace(xcm=xcm, vcm=vcm, R=R, ang_mom=ang_mom,
                         omega=omega,
                         inertia_tensor_inverse_global_frame=Iinv)


def build_rigid_leapfrog_step(kernel, cfg, params: dict, cell_cfg=None):
    """Reference ``LeapFrogRigidBody3DStep`` under the GTVF sequencing
    (save -> half-advance with stored force -> force eval -> full
    advance from saved).  3D only, like the reference stepper.  Runs on
    the cell engine when ``cell_cfg`` is given."""
    force_eval = _make_force_eval(kernel, params, nbr_cfg=cfg,
                                  cell_cfg=cell_cfg)

    @jax.jit
    def step(scene: Scene, dt):
        scene = scene.replace(xcm0=scene.xcm, vcm0=scene.vcm,
                              ang_mom0=scene.ang_mom, R0=scene.R)
        scene = _leapfrog_body_stage(scene, 0.5 * dt)
        scene = _particles_from_body_position(scene)
        scene = _particles_from_body_velocity(scene)
        scene = force_eval(scene, dt)
        scene = _leapfrog_body_stage(scene, dt)
        scene = _particles_from_body_position(scene)
        scene = _particles_from_body_velocity(scene)
        return scene

    return step


def make_multi_step(step, n: int):
    """Chain n steps inside one device program via lax.scan."""

    @jax.jit
    def multi(scene: Scene, dt):
        def body(s, _):
            return step(s, dt), None

        out, _ = jax.lax.scan(body, scene, None, length=n)
        return out

    return multi

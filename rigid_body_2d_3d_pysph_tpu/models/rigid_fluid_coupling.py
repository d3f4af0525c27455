"""Rigid-fluid coupling scheme: WCSPH (optionally EDAC) fluid + Adami
wall BC + Akinci-style two-way FSI + the rigid contact pipeline, in one
fused GTVF step.

Re-design of the reference's ``RigidFluidCouplingScheme``
(``code/rigid_fluid_coupling.py:555-1084``).  Equation assembly parity
(reference ``get_equations`` :636-799):

stage-1 evaluation (fluid density/pressure rates):
  ContinuityEquation(fluid <- fluid+boundary) [+ EDACEquation]
  ContinuityEquationFSI(fluid <- rigid)       [+ EDACEquationFSI]
stage-2 evaluation:
  [no-EDAC] TaitEOS(fluid)
  SetWallVelocity + SolidWallPressureBC + ClampWallPressure  (boundary)
  SetWallVelocity + SolidWallPressureBCFSI                   (rigid; no
    clamp — commented out in the reference :716-717)
  fluid momentum: ArtificialViscosity + PressureGradient (+g) +
    ForceOnFluidDuetoRigidBody
  rigid contact pipeline G1..G6 with ForceOnRigidBodyDuetoFluid added
    before the per-body sum (:784-788)

Steppers: ``GTVFFluidStep`` (:273-298) for fluids and the 3D rigid-body
GTVF stepper for bodies (:301-486, an exact copy of rigid_body_3d's).
The fluid's first half-kick uses the acceleration stored from the
previous step's stage-2 evaluation (stage-1 equations never touch au),
so ``au/av/aw`` persist in the Scene.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import cellpairs as cellmod
from ..ops import fluid as fops
from ..ops import fluid_cell as fcops
from ..ops import neighbors as nbmod
from ..ops.cellpairs import pack_fields
from ..ops.kernels import get_kernel
from ..state import rigid_setup
from ..state.scene import Scene
from .base import Scheme
from .rigid_body import (
    _attach_contact_fields,
    _body_half_kick,
    _body_drift,
    _particles_from_body_velocity,
    _particles_from_body_position,
    rigid_contact_force_eval,
    rigid_contact_force_eval_cell,
    run_boundary_identification,
)


class RigidFluidCouplingScheme(Scheme):
    name = "rfc"

    def __init__(self, fluids, boundaries, rigid_bodies, dim, rho0, p0, c0,
                 h, nu, kr=1e5, kf=1e5, en=0.5, fric_coeff=0.5, gamma=7.0,
                 gx=0.0, gy=0.0, gz=0.0, alpha=0.1, beta=0.0,
                 kernel_choice="1", kernel_factor=3, edac_alpha=0.5):
        self.fluids = list(fluids or [])
        self.boundaries = list(boundaries or [])
        self.rigid_bodies = list(rigid_bodies or [])
        self.dim = dim
        # coerce to PYTHON floats: numpy scalars are strong-typed in JAX
        # promotion, so an np.float64 c0 would silently promote the f32
        # step's math to f64
        self.rho0, self.p0, self.c0, self.gamma = (
            float(rho0), float(p0), float(c0), float(gamma))
        self.h = float(h)
        self.nu = float(nu)
        self.kr, self.kf, self.en, self.fric_coeff = (
            float(kr), float(kf), float(en), float(fric_coeff))
        self.gx, self.gy, self.gz = float(gx), float(gy), float(gz)
        self.fluid_alpha = float(alpha)
        self.beta = float(beta)
        self.edac = True
        self.edac_alpha = edac_alpha
        self.kernel_name = "quintic"
        # GTVF stage ordering.  "reference" reproduces the PySPH order
        # (rates at u_n pre-kick, momentum at p_n pre-drift — an
        # Adams-Bashforth-like staging of the acoustic subsystem);
        # "kdk" is the symplectic kick-drift-kick staging
        # (density/pressure rates at u_{n+1/2}, momentum + wall BC
        # evaluated after the drift at (x_{n+1}, p_{n+1})).  Round-2
        # measurement note: on the hydrostatic-tank regression both
        # orderings show the SAME slow startup-sloshing KE growth at the
        # reference's own c0/dt (e-fold ~230 steps, ordering-independent
        # to <2%) — the round-1 claim of a reference-ordering-specific
        # instability did not reproduce.  "kdkf" (round 4, the default)
        # is KDK with the grid/pack schedule fused: one grid build and
        # one pack per step, drift before the evaluations, thermo
        # updates patched through the pack as dense column writes (cell
        # engine; on nklist it runs as kdk).  Its wall sums sample source
        # rho/p pre-update — the reference's own staging; kdk samples
        # post-drift (tests/test_fluid_coupling.py pins the deviation).
        self.gtvf_ordering = "kdkf"
        # "gtvf" (the reference's wired stepper) or "rk2": the
        # reference defines RK2FluidStep (rigid_fluid_coupling.py:228-271)
        # but its scheme hard-codes GTVF (:815) so RK2 is dead code
        # there; here it is a live predictor-corrector coupling step
        # (fluid RK2FluidStep semantics + RK2RigidBody3DStep body stage)
        # on the cell engine, Tait EOS only (the reference step carries
        # no p0/ap state, i.e. it predates EDAC).
        self.fluid_stepper = "gtvf"
        self.dt = None
        self.tf = None
        self.pfreq = 100
        self._nbr_cfg: Optional[nbmod.NeighborConfig] = None
        self._cell_cfg: Optional[cellmod.CellGridConfig] = None

    @property
    def edac_nu(self):
        """nu_edac = alpha h c0 / 8 (reference ``attributes_changed``
        :633-634)."""
        return self.fluid_alpha * self.h * self.c0 / 8.0

    def add_user_options(self, group):
        group.add_argument("--kr-stiffness", dest="kr", default=1e5,
                           type=float)
        group.add_argument("--kf-stiffness", dest="kf", default=1e3,
                           type=float)
        group.add_argument("--fric-coeff", dest="fric_coeff", default=0.5,
                           type=float)
        group.add_argument("--fluid-alpha", dest="fluid_alpha", default=0.5,
                           type=float, help="Artificial viscosity")
        group.add_argument("--edac", dest="edac", action="store_true",
                           default=True)
        group.add_argument("--no-edac", dest="edac", action="store_false")
        group.add_argument("--gtvf-ordering", dest="gtvf_ordering",
                           choices=("kdk", "kdkf", "reference"),
                           default=None,
                           help="GTVF stage ordering: kdk (two-build "
                                "kick-drift-kick), kdkf (fused one-grid "
                                "KDK on the cell engine), reference "
                                "(PySPH staging)")

    def consume_user_options(self, options):
        for k in ("kr", "kf", "fric_coeff", "fluid_alpha", "edac"):
            if hasattr(options, k):
                setattr(self, k, getattr(options, k))
        if getattr(options, "gtvf_ordering", None):
            self.gtvf_ordering = options.gtvf_ordering

    # -- setup ------------------------------------------------------------
    def setup(self, scene: Scene, coeff_of_rest=None,
              identify_boundaries: bool = True) -> Scene:
        """State attachment mirroring ``setup_properties`` (:835-1030):
        rigid contact slots + body state + FSI shadow fields + Adami
        ghost fields; fluid rate/EOS fields."""
        fdt = config.float_dtype()
        n = scene.n
        scene = _attach_contact_fields(scene)
        if scene.meta.nb > 0:
            scene = rigid_setup.setup_body_state(scene, coeff_of_rest)
        add = {}
        for k in ("rho_fsi", "m_fsi", "p_fsi", "wij_adami",
                  "uf", "vf", "wf", "ug", "vg", "wg",
                  "arho", "ap", "au", "av", "aw", "vol", "cs",
                  # RK2FluidStep saved state (reference x0/.../rho0
                  # particle props, :229-240)
                  "x0", "y0", "z0", "u0", "v0", "w0", "rho0_rk"):
            if k not in scene:
                add[k] = jnp.zeros(n, fdt)
        scene = scene.with_fields(**add)
        rho_safe = np.where(np.asarray(scene.rho) > 0, np.asarray(scene.rho),
                            1.0)
        scene = scene.replace(
            vol=jnp.asarray(np.asarray(scene.m) / rho_safe, fdt),
            cs=jnp.full(n, self.c0, fdt),
        )
        kernel = get_kernel(self.kernel_name, self.dim)
        if identify_boundaries and (self.rigid_bodies or self.boundaries):
            names = self.rigid_bodies + self.boundaries
            if self.engine == "cell":
                from .rigid_body import run_boundary_identification_cell
                scene = run_boundary_identification_cell(
                    scene, kernel, self.cell_config(scene, kernel), names)
            else:
                self._nbr_cfg = self.neighbor_config(scene,
                                                     kernel.radius_scale)
                scene = run_boundary_identification(
                    scene, kernel, self._nbr_cfg, names)
            cfib = np.asarray(scene.is_boundary).astype(np.float64)
            scene = scene.replace(
                contact_force_is_boundary=jnp.asarray(cfib, fdt))
        return scene

    def set_linear_velocity(self, scene, vel):
        return rigid_setup.set_linear_velocity(scene, vel)

    def set_angular_velocity(self, scene, omega):
        return rigid_setup.set_angular_velocity(scene, omega)

    def cell_config(self, scene: Scene, kernel) -> cellmod.CellGridConfig:
        if self._cell_cfg is None:
            cutoff = float(kernel.radius_scale * np.asarray(scene.h).max())
            # fluid + body phases can interpenetrate the same cells at
            # run time (e.g. a body sinking into fluid), up to doubling
            # the initial occupancy — size the lanes for it
            self._cell_cfg = cellmod.config_from_positions(
                np.asarray(scene.x), np.asarray(scene.y),
                np.asarray(scene.z), cutoff, self.dim,
                occupancy_safety=2.6,
                capacity_boost=self.capacity_boost)
        return self._cell_cfg

    def make_step(self, scene: Scene):
        if getattr(self, "fluid_stepper", "gtvf") == "rk2":
            if self.engine != "cell":
                raise NotImplementedError("rk2 fluid stepper: cell engine")
            if self.edac:
                raise NotImplementedError(
                    "rk2 fluid stepper integrates rho only (reference "
                    "RK2FluidStep :228-271 has no p0/ap state) — use "
                    "Tait EOS (edac=False)")
            return self._make_step_cell_rk2(scene)
        if self.gtvf_ordering == "kdkf":
            if self.engine == "cell" and self.fluids:
                return self._make_step_cell_kdkf(scene)
            # no fluids (or [N,K] engine): kdkf degenerates to kdk —
            # the fusion only changes the FLUID grid/pack schedule
            saved = self.gtvf_ordering
            self.gtvf_ordering = "kdk"
            try:
                return self.make_step(scene)
            finally:
                self.gtvf_ordering = saved
        if self.engine == "cell":
            return self._make_step_cell(scene)
        return self._make_step_nklist(scene)

    def _make_step_cell_rk2(self, scene: Scene):
        """Predictor-corrector coupling step: RK2FluidStep fluid
        semantics (x from saved with CURRENT u, then u from saved with
        current au, rho from saved with current arho — reference
        :244-271) + the RK2 rigid body stage, two full evaluations per
        step on the cell engine."""
        from .rigid_body import _rk2_body_stage
        kernel = get_kernel(self.kernel_name, self.dim)
        ccfg = self.cell_config(scene, kernel)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        gx, gy, gz = self.gx, self.gy, self.gz
        nu_edac = self.edac_nu
        c0, rho0, gamma = self.c0, self.rho0, self.gamma
        fluid_alpha = self.fluid_alpha
        has_fluid = len(self.fluids) > 0
        has_rigid = len(self.rigid_bodies) > 0

        def evaluate(scene, dt, fl, bd, rb, solid):
            """Rates + wall BC + momentum + contact at the current
            state -> (scene with arho/au/force/torque, overflow)."""
            grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                           scene.active, ccfg)
            ovf = grid.overflow
            ffx = ffy = ffz = None
            if has_fluid:
                p, cs = fops.tait_eos(scene, rho0, c0, gamma, fl)
                scene = scene.replace(p=p, cs=cs)
                df, di = fcops.pack_fluid_scene(scene, grid, ccfg)
                arho, _ = fcops.fluid_rates_cell(
                    scene, grid, ccfg, kernel, df, di, nu_edac, c0,
                    False, has_rigid)
                scene = scene.replace(arho=jnp.where(fl, arho, 0.0))
                uf, vf, wf, sw, p_num = fcops.wall_bc_cell(
                    scene, grid, ccfg, kernel, df, di, gx, gy, gz)
                has = sw > 1e-14
                p_bc = jnp.where(has, p_num / jnp.where(has, sw, 1.0),
                                 p_num)
                inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
                ufn, vfn, wfn = uf * inv, vf * inv, wf * inv
                scene = scene.replace(
                    p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene.p),
                    p_fsi=jnp.where(rb, p_bc, scene.p_fsi),
                    uf=jnp.where(solid, ufn, scene.uf),
                    vf=jnp.where(solid, vfn, scene.vf),
                    wf=jnp.where(solid, wfn, scene.wf),
                    ug=jnp.where(solid, 2.0 * scene.u - ufn, scene.ug),
                    vg=jnp.where(solid, 2.0 * scene.v - vfn, scene.vg),
                    wg=jnp.where(solid, 2.0 * scene.w - wfn, scene.wg),
                    wij_adami=jnp.where(solid, sw, scene.wij_adami),
                )
                p_dense = pack_fields(grid, ccfg, [scene.p], [0.0])[..., 0]
                pfsi_dense = pack_fields(grid, ccfg, [scene.p_fsi],
                                         [0.0])[..., 0]
                aux, auy, auz, fxv, fyv, fzv = fcops.fluid_forces_cell(
                    scene, grid, ccfg, kernel, df, di, p_dense,
                    pfsi_dense, fluid_alpha, c0, has_rigid)
                scene = scene.replace(
                    au=jnp.where(fl, gx + aux, 0.0),
                    av=jnp.where(fl, gy + auy, 0.0),
                    aw=jnp.where(fl, gz + auz, 0.0),
                )
                ffx = jnp.where(rb, fxv, 0.0)
                ffy = jnp.where(rb, fyv, 0.0)
                ffz = jnp.where(rb, fzv, 0.0)
            if has_rigid:
                extra = (ffx, ffy, ffz) if has_fluid else None
                scene = rigid_contact_force_eval_cell(
                    scene, grid, ccfg, kernel, params, dt, extra_fx=extra)
            return scene, ovf

        def stage(scene, frac_dt, fl):
            """RK2FluidStep stage: positions from saved with the
            CURRENT velocity, then velocity/density from saved with
            the current derivatives (reference :244-255)."""
            if has_fluid:
                rho_new = scene.rho0_rk + frac_dt * scene.arho
                scene = scene.replace(
                    x=jnp.where(fl, scene.x0 + frac_dt * scene.u,
                                scene.x),
                    y=jnp.where(fl, scene.y0 + frac_dt * scene.v,
                                scene.y),
                    z=jnp.where(fl, scene.z0 + frac_dt * scene.w,
                                scene.z),
                    u=jnp.where(fl, scene.u0 + frac_dt * scene.au,
                                scene.u),
                    v=jnp.where(fl, scene.v0 + frac_dt * scene.av,
                                scene.v),
                    w=jnp.where(fl, scene.w0 + frac_dt * scene.aw,
                                scene.w),
                    rho=jnp.where(fl, rho_new, scene.rho),
                    vol=jnp.where(fl, scene.m / rho_new, scene.vol),
                )
            if has_rigid:
                scene = _rk2_body_stage(scene, frac_dt, two_d=False)
                scene = _particles_from_body_position(scene)
                scene = _particles_from_body_velocity(scene)
            return scene

        @jax.jit
        def step(scene: Scene, dt):
            fl = scene.is_fluid & scene.active
            bd = scene.is_static_boundary & scene.active
            rb = scene.is_rigid & scene.active
            solid = bd | rb
            # initialize: save t=0 state (reference :229-240)
            save = {}
            if has_fluid:
                save.update(x0=scene.x, y0=scene.y, z0=scene.z,
                            u0=scene.u, v0=scene.v, w0=scene.w,
                            rho0_rk=scene.rho)
            if has_rigid:
                save.update(xcm0=scene.xcm, vcm0=scene.vcm,
                            ang_mom0=scene.ang_mom, omega0=scene.omega,
                            R0=scene.R)
            scene = scene.replace(**save)
            scene, ovf1 = evaluate(scene, dt, fl, bd, rb, solid)
            scene = stage(scene, 0.5 * dt, fl)
            scene, ovf2 = evaluate(scene, dt, fl, bd, rb, solid)
            scene = stage(scene, dt, fl)
            return scene.replace(
                nbr_overflow=scene.nbr_overflow | ovf1 | ovf2)

        return step

    def _make_step_cell_kdkf(self, scene: Scene):
        """Fused KDK: ONE grid build and ONE fluid pack per step.

        The two-build kdk step evaluates the density/pressure rates on a
        grid at x_n, drifts, then rebuilds at x_{n+1} for wall-BC /
        momentum / contact, repacking the fluid fields each time.  Here the
        drift moves positions FIRST (x_{n+1} = x_n + dt u_{n+1/2} needs
        no pair sums), all four pair passes share the post-drift grid,
        and the thermodynamic state updates flow through the pack as
        dense COLUMN patches (elementwise [NC, M] writes, no gathers):

          kick -> drift(x) -> build+pack -> rates -> patch rho,p ->
          wall BC -> patch p,p_fsi -> forces -> contact -> kick

        The passes' per-particle outputs leave dense space through ONE
        combined 13-column unpack.  Staging note: the rates are
        evaluated at (u_{n+1/2}, x_{n+1}) where the two-build kdk uses
        (u_{n+1/2}, x_n) — both are consistent O(dt) stagings of the
        acoustic subsystem (reference itself uses (u_n, x_n),
        ``code/rigid_fluid_coupling.py:652-673``); the hydrostatic-rest,
        energy-regression and sinking-box added-mass gates all hold (see
        tests/test_fluid_coupling.py, validate.py)."""
        kernel = get_kernel(self.kernel_name, self.dim)
        ccfg = self.cell_config(scene, kernel)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        gx, gy, gz = self.gx, self.gy, self.gz
        edac = self.edac
        nu_edac = self.edac_nu
        c0, rho0, gamma = self.c0, self.rho0, self.gamma
        fluid_alpha = self.fluid_alpha
        has_rigid = len(self.rigid_bodies) > 0
        RHO, P, PFSI = fcops._FRHO, fcops._FP, fcops._FPFSI
        FLU, BDR, RIG = fcops._IFLUID, fcops._IBDRY, fcops._IRIGID

        def eval_passes(scene, dt):
            """Grid build + all fluid passes on one pack with dense
            column patches between them.  Returns ``(grid, out)``:
            ``out`` the [N, 13] block (arho, ap, uf, vf, wf, sw, p_num,
            au, av, aw, fx, fy, fz)."""
            grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                           scene.active, ccfg)
            df, di = fcops.pack_fluid_scene(scene, grid, ccfg)
            fl_l = di[:, :, FLU] == 1
            bd_l = di[:, :, BDR] == 1
            rb_l = di[:, :, RIG] == 1
            arho_d, ap_d = fcops.fluid_rates_cell(
                scene, grid, ccfg, kernel, df, di, nu_edac, c0,
                edac, has_rigid, dense=True)
            # wall sums on the PRE-update pack: the reference's staging
            # (it runs its stage-2 wall BC before the drift updates rho/p)
            uf_d, vf_d, wf_d, sw_d, pnum_d = fcops.wall_bc_cell(
                scene, grid, ccfg, kernel, df, di, gx, gy, gz,
                dense=True)
            rho_d = df[:, :, RHO]
            p_d = df[:, :, P]
            rho_new = jnp.where(fl_l, rho_d + dt * arho_d, rho_d)
            if edac:
                p_new = jnp.where(fl_l, p_d + dt * ap_d, p_d)
            else:
                B = c0 * c0 * rho0 / gamma
                p_new = jnp.where(
                    fl_l, B * ((rho_new / rho0) ** gamma - 1.0), p_d)
            df = df.at[:, :, RHO].set(rho_new)

            has_d = sw_d > 1e-14
            pbc_d = jnp.where(has_d,
                              pnum_d / jnp.where(has_d, sw_d, 1.0),
                              pnum_d)
            p2 = jnp.where(bd_l, jnp.maximum(pbc_d, 0.0), p_new)
            pfsi2 = jnp.where(rb_l, pbc_d, df[:, :, PFSI])
            # forces read the patched pressures through their own
            # dense operands (df's p column stays stale, unused)
            outs = fcops.fluid_forces_cell(
                scene, grid, ccfg, kernel, df, di, p2, pfsi2,
                fluid_alpha, c0, has_rigid, dense=True)
            dense_all = jnp.stack(
                [arho_d, ap_d, uf_d, vf_d, wf_d, sw_d, pnum_d]
                + list(outs), axis=-1)
            return grid, cellmod.unpack(grid, ccfg, dense_all, scene.n,
                                        0.0).astype(scene.x.dtype)

        @jax.jit
        def step_kdkf(scene: Scene, dt):
            fl = scene.is_fluid & scene.active
            bd = scene.is_static_boundary & scene.active
            rb = scene.is_rigid & scene.active
            solid = bd | rb

            # ---- kick (half, stored accelerations/forces) ----
            scene = scene.replace(
                u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
            )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)

            # ---- drift positions (thermo update rides the pack) ----
            scene = scene.replace(
                x=jnp.where(fl, scene.x + dt * scene.u, scene.x),
                y=jnp.where(fl, scene.y + dt * scene.v, scene.y),
                z=jnp.where(fl, scene.z + dt * scene.w, scene.z),
            )
            if has_rigid:
                scene = _body_drift(scene, dt, two_d=False)
                scene = _particles_from_body_position(scene)

            # ---- ONE grid + pack; rates -> thermo -> BC -> forces ----
            grid, out = eval_passes(scene, dt)   # [N, 13]
            ovf = scene.nbr_overflow | grid.overflow
            arho = jnp.where(fl, out[:, 0], 0.0)
            ap = jnp.where(fl, out[:, 1], 0.0)
            rho_new = scene.rho + dt * arho
            upd = dict(
                arho=arho, ap=ap,
                rho=jnp.where(fl, rho_new, scene.rho),
                vol=jnp.where(fl, scene.m / rho_new, scene.vol),
            )
            if edac:
                upd["p"] = jnp.where(fl, scene.p + dt * ap, scene.p)
            else:
                p_t, cs_t = fops.tait_eos(
                    scene.replace(rho=upd["rho"]), rho0, c0, gamma, fl)
                upd["p"], upd["cs"] = p_t, cs_t
            scene = scene.replace(**upd)

            sw = out[:, 5]
            has = sw > 1e-14
            p_bc = jnp.where(has, out[:, 6] / jnp.where(has, sw, 1.0),
                             out[:, 6])
            inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
            ufn, vfn, wfn = out[:, 2] * inv, out[:, 3] * inv, \
                out[:, 4] * inv
            scene = scene.replace(
                p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene.p),
                p_fsi=jnp.where(rb, p_bc, scene.p_fsi),
                uf=jnp.where(solid, ufn, scene.uf),
                vf=jnp.where(solid, vfn, scene.vf),
                wf=jnp.where(solid, wfn, scene.wf),
                ug=jnp.where(solid, 2.0 * scene.u - ufn, scene.ug),
                vg=jnp.where(solid, 2.0 * scene.v - vfn, scene.vg),
                wg=jnp.where(solid, 2.0 * scene.w - wfn, scene.wg),
                wij_adami=jnp.where(solid, sw, scene.wij_adami),
                au=jnp.where(fl, gx + out[:, 7], 0.0),
                av=jnp.where(fl, gy + out[:, 8], 0.0),
                aw=jnp.where(fl, gz + out[:, 9], 0.0),
            )
            if has_rigid:
                extra = (jnp.where(rb, out[:, 10], 0.0),
                         jnp.where(rb, out[:, 11], 0.0),
                         jnp.where(rb, out[:, 12], 0.0))
                scene = rigid_contact_force_eval_cell(
                    scene, grid, ccfg, kernel, params, dt, extra_fx=extra)
            scene = scene.replace(nbr_overflow=ovf)

            # ---- second half-kick with the fresh accelerations ----
            scene = scene.replace(
                u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
            )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)
            return scene

        return step_kdkf

    def _make_step_cell(self, scene: Scene):
        """Coupling step on the dense cell engine: three fluid passes +
        two contact passes per step (see ops.fluid_cell)."""
        kernel = get_kernel(self.kernel_name, self.dim)
        ccfg = self.cell_config(scene, kernel)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        gx, gy, gz = self.gx, self.gy, self.gz
        edac = self.edac
        nu_edac = self.edac_nu
        c0, rho0, gamma = self.c0, self.rho0, self.gamma
        fluid_alpha = self.fluid_alpha
        has_fluid = len(self.fluids) > 0
        has_rigid = len(self.rigid_bodies) > 0

        def run_rates(scene, grid):
            df, di = fcops.pack_fluid_scene(scene, grid, ccfg)
            return fcops.fluid_rates_cell(
                scene, grid, ccfg, kernel, df, di, nu_edac, c0, edac,
                has_rigid)

        def run_wall_bc(scene, grid):
            """-> (uf, vf, wf, sw, p_num, ctx); ctx threads the packed
            fields to run_forces."""
            df, di = fcops.pack_fluid_scene(scene, grid, ccfg)
            return fcops.wall_bc_cell(
                scene, grid, ccfg, kernel, df, di, gx, gy, gz) + ((df, di),)

        def run_forces(scene, grid, ctx):
            df, di = ctx
            p_dense = pack_fields(grid, ccfg, [scene.p], [0.0])[..., 0]
            pfsi_dense = pack_fields(grid, ccfg, [scene.p_fsi],
                                     [0.0])[..., 0]
            return fcops.fluid_forces_cell(
                scene, grid, ccfg, kernel, df, di, p_dense, pfsi_dense,
                fluid_alpha, c0, has_rigid)

        if self.gtvf_ordering == "kdk":
            @jax.jit
            def step_kdk(scene: Scene, dt):
                fl = scene.is_fluid & scene.active
                bd = scene.is_static_boundary & scene.active
                rb = scene.is_rigid & scene.active
                solid = bd | rb

                # ---- kick (half, stored accelerations/forces) ----
                if has_fluid:
                    scene = scene.replace(
                        u=jnp.where(fl, scene.u + 0.5 * dt * scene.au,
                                    scene.u),
                        v=jnp.where(fl, scene.v + 0.5 * dt * scene.av,
                                    scene.v),
                        w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw,
                                    scene.w),
                    )
                if has_rigid:
                    scene = _body_half_kick(scene, dt, two_d=False)
                    scene = _particles_from_body_velocity(scene)

                # ---- density/pressure rates at u_{n+1/2}, x_n ----
                ovf = scene.nbr_overflow
                if has_fluid:
                    grid = cellmod.build_cell_grid(
                        scene.x, scene.y, scene.z, scene.active, ccfg)
                    ovf = ovf | grid.overflow
                    arho, ap = run_rates(scene, grid)
                    scene = scene.replace(arho=jnp.where(fl, arho, 0.0),
                                          ap=jnp.where(fl, ap, 0.0))

                # ---- drift + thermodynamic update ----
                if has_fluid:
                    rho_new = scene.rho + dt * scene.arho
                    upd = dict(
                        x=jnp.where(fl, scene.x + dt * scene.u, scene.x),
                        y=jnp.where(fl, scene.y + dt * scene.v, scene.y),
                        z=jnp.where(fl, scene.z + dt * scene.w, scene.z),
                        rho=jnp.where(fl, rho_new, scene.rho),
                        vol=jnp.where(fl, scene.m / rho_new, scene.vol),
                    )
                    if edac:
                        upd["p"] = jnp.where(fl, scene.p + dt * scene.ap,
                                             scene.p)
                    scene = scene.replace(**upd)
                if has_rigid:
                    scene = _body_drift(scene, dt, two_d=False)
                    scene = _particles_from_body_position(scene)

                # ---- forces at (x_{n+1}, p_{n+1}, u_{n+1/2}) ----
                grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                               scene.active, ccfg)
                ovf = ovf | grid.overflow
                if has_fluid:
                    if not edac:
                        p, cs = fops.tait_eos(scene, rho0, c0, gamma, fl)
                        scene = scene.replace(p=p, cs=cs)
                    uf, vf, wf, sw, p_num, fctx = run_wall_bc(scene, grid)
                    has = sw > 1e-14
                    p_bc = jnp.where(has, p_num / jnp.where(has, sw, 1.0),
                                     p_num)
                    inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
                    ufn, vfn, wfn = uf * inv, vf * inv, wf * inv
                    scene = scene.replace(
                        p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene.p),
                        p_fsi=jnp.where(rb, p_bc, scene.p_fsi),
                        uf=jnp.where(solid, ufn, scene.uf),
                        vf=jnp.where(solid, vfn, scene.vf),
                        wf=jnp.where(solid, wfn, scene.wf),
                        ug=jnp.where(solid, 2.0 * scene.u - ufn, scene.ug),
                        vg=jnp.where(solid, 2.0 * scene.v - vfn, scene.vg),
                        wg=jnp.where(solid, 2.0 * scene.w - wfn, scene.wg),
                        wij_adami=jnp.where(solid, sw, scene.wij_adami),
                    )
                    aux, auy, auz, ffx, ffy, ffz = run_forces(scene, grid,
                                                              fctx)
                    scene = scene.replace(
                        au=jnp.where(fl, gx + aux, 0.0),
                        av=jnp.where(fl, gy + auy, 0.0),
                        aw=jnp.where(fl, gz + auz, 0.0),
                    )
                if has_rigid:
                    extra = None
                    if has_fluid:
                        extra = (jnp.where(rb, ffx, 0.0),
                                 jnp.where(rb, ffy, 0.0),
                                 jnp.where(rb, ffz, 0.0))
                    scene = rigid_contact_force_eval_cell(
                        scene, grid, ccfg, kernel, params, dt,
                        extra_fx=extra)
                scene = scene.replace(nbr_overflow=ovf)

                # ---- second half-kick with the fresh accelerations ----
                if has_fluid:
                    scene = scene.replace(
                        u=jnp.where(fl, scene.u + 0.5 * dt * scene.au,
                                    scene.u),
                        v=jnp.where(fl, scene.v + 0.5 * dt * scene.av,
                                    scene.v),
                        w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw,
                                    scene.w),
                    )
                if has_rigid:
                    scene = _body_half_kick(scene, dt, two_d=False)
                    scene = _particles_from_body_velocity(scene)
                return scene

            return step_kdk

        @jax.jit
        def step(scene: Scene, dt):
            fl = scene.is_fluid & scene.active
            bd = scene.is_static_boundary & scene.active
            rb = scene.is_rigid & scene.active

            grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                           scene.active, ccfg)

            # ---- stage-1 equations: fluid rates (pre-kick velocities) --
            if has_fluid:
                arho, ap = run_rates(scene, grid)
                scene = scene.replace(arho=jnp.where(fl, arho, 0.0),
                                      ap=jnp.where(fl, ap, 0.0))

            # ---- stepper stage 1 ----
            if has_fluid:
                scene = scene.replace(
                    u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                    v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                    w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
                )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)

            # ---- stage-2 equations (post-kick velocities, same grid) ---
            if has_fluid:
                if not edac:
                    p, cs = fops.tait_eos(scene, rho0, c0, gamma, fl)
                    scene = scene.replace(p=p, cs=cs)
                uf, vf, wf, sw, p_num, fctx = run_wall_bc(scene, grid)
                has = sw > 1e-14
                p_bc = jnp.where(has, p_num / jnp.where(has, sw, 1.0),
                                 p_num)
                inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
                ufn, vfn, wfn = uf * inv, vf * inv, wf * inv
                solid = bd | rb
                scene = scene.replace(
                    p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene.p),
                    p_fsi=jnp.where(rb, p_bc, scene.p_fsi),
                    uf=jnp.where(solid, ufn, scene.uf),
                    vf=jnp.where(solid, vfn, scene.vf),
                    wf=jnp.where(solid, wfn, scene.wf),
                    ug=jnp.where(solid, 2.0 * scene.u - ufn, scene.ug),
                    vg=jnp.where(solid, 2.0 * scene.v - vfn, scene.vg),
                    wg=jnp.where(solid, 2.0 * scene.w - wfn, scene.wg),
                    wij_adami=jnp.where(solid, sw, scene.wij_adami),
                )
                aux, auy, auz, ffx, ffy, ffz = run_forces(scene, grid,
                                                          fctx)
                scene = scene.replace(
                    au=jnp.where(fl, gx + aux, 0.0),
                    av=jnp.where(fl, gy + auy, 0.0),
                    aw=jnp.where(fl, gz + auz, 0.0),
                )
            if has_rigid:
                extra = None
                if has_fluid:
                    extra = (jnp.where(rb, ffx, 0.0),
                             jnp.where(rb, ffy, 0.0),
                             jnp.where(rb, ffz, 0.0))
                scene = rigid_contact_force_eval_cell(
                    scene, grid, ccfg, kernel, params, dt, extra_fx=extra)

            scene = scene.replace(
                nbr_overflow=scene.nbr_overflow | grid.overflow)

            # ---- stepper stage 2 (drift) ----
            if has_fluid:
                rho_new = scene.rho + dt * scene.arho
                upd = dict(
                    x=jnp.where(fl, scene.x + dt * scene.u, scene.x),
                    y=jnp.where(fl, scene.y + dt * scene.v, scene.y),
                    z=jnp.where(fl, scene.z + dt * scene.w, scene.z),
                    rho=jnp.where(fl, rho_new, scene.rho),
                    vol=jnp.where(fl, scene.m / rho_new, scene.vol),
                )
                if edac:
                    upd["p"] = jnp.where(fl, scene.p + dt * scene.ap,
                                         scene.p)
                scene = scene.replace(**upd)
            if has_rigid:
                scene = _body_drift(scene, dt, two_d=False)
                scene = _particles_from_body_position(scene)

            # ---- stepper stage 3 ----
            if has_fluid:
                scene = scene.replace(
                    u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                    v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                    w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
                )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)
            return scene

        return step

    def _make_step_nklist(self, scene: Scene):
        kernel = get_kernel(self.kernel_name, self.dim)
        if self._nbr_cfg is None:
            self._nbr_cfg = self.neighbor_config(scene, kernel.radius_scale)
        cfg = self._nbr_cfg
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        gx, gy, gz = self.gx, self.gy, self.gz
        edac = self.edac
        nu_edac = self.edac_nu
        c0, rho0, gamma = self.c0, self.rho0, self.gamma
        fluid_alpha = self.fluid_alpha
        has_fluid = len(self.fluids) > 0
        has_rigid = len(self.rigid_bodies) > 0

        def fluid_stage2(scene, nbrs, fl, bd, rb, fl_bd):
            """Wall/body BC + fluid momentum (shared by both orderings)."""
            if not edac:
                p, cs = fops.tait_eos(scene, rho0, c0, gamma, fl)
                scene = scene.replace(p=p, cs=cs)
            uf, vf, wf, ug, vg, wg, sw = fops.set_wall_velocity(
                scene, nbrs, kernel, bd, fl)
            p_wall = fops.solid_wall_pressure_bc(
                scene, nbrs, kernel, gx, gy, gz, bd, fl, sw, clamp=True)
            scene = scene.replace(
                p=jnp.where(bd, p_wall, scene.p),
                uf=jnp.where(bd, uf, scene.uf),
                vf=jnp.where(bd, vf, scene.vf),
                wf=jnp.where(bd, wf, scene.wf),
                ug=jnp.where(bd, ug, scene.ug),
                vg=jnp.where(bd, vg, scene.vg),
                wg=jnp.where(bd, wg, scene.wg),
                wij_adami=jnp.where(bd, sw, scene.wij_adami),
            )
            if has_rigid:
                uf, vf, wf, ug, vg, wg, sw = fops.set_wall_velocity(
                    scene, nbrs, kernel, rb, fl)
                p_fsi = fops.solid_wall_pressure_bc(
                    scene, nbrs, kernel, gx, gy, gz, rb, fl, sw,
                    clamp=False)
                scene = scene.replace(
                    p_fsi=jnp.where(rb, p_fsi, scene.p_fsi),
                    uf=jnp.where(rb, uf, scene.uf),
                    vf=jnp.where(rb, vf, scene.vf),
                    wf=jnp.where(rb, wf, scene.wf),
                    ug=jnp.where(rb, ug, scene.ug),
                    vg=jnp.where(rb, vg, scene.vg),
                    wg=jnp.where(rb, wg, scene.wg),
                    wij_adami=jnp.where(rb, sw, scene.wij_adami),
                )
            aux, auy, auz = fops.momentum_pressure_gradient(
                scene, nbrs, kernel, fl, fl_bd)
            if abs(fluid_alpha) > 1e-14:
                vx, vy, vz = fops.momentum_artificial_viscosity(
                    scene, nbrs, kernel, fluid_alpha, c0, fl, fl)
                aux, auy, auz = aux + vx, auy + vy, auz + vz
            if has_rigid:
                rx, ry, rz = fops.force_on_fluid_due_to_rigid_body(
                    scene, nbrs, kernel, fl, rb)
                aux, auy, auz = aux + rx, auy + ry, auz + rz
            return scene.replace(
                au=jnp.where(fl, gx + aux, 0.0),
                av=jnp.where(fl, gy + auy, 0.0),
                aw=jnp.where(fl, gz + auz, 0.0),
            )

        if self.gtvf_ordering == "kdk":
            @jax.jit
            def step_kdk(scene: Scene, dt):
                """KDK ordering on the [N,K] engine (mirrors the cell
                engine's step_kdk; documented stability deviation from
                the reference staging)."""
                fl = scene.is_fluid & scene.active
                bd = scene.is_static_boundary & scene.active
                rb = scene.is_rigid & scene.active
                fl_bd = fl | bd

                if has_fluid:
                    scene = scene.replace(
                        u=jnp.where(fl, scene.u + 0.5 * dt * scene.au,
                                    scene.u),
                        v=jnp.where(fl, scene.v + 0.5 * dt * scene.av,
                                    scene.v),
                        w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw,
                                    scene.w),
                    )
                if has_rigid:
                    scene = _body_half_kick(scene, dt, two_d=False)
                    scene = _particles_from_body_velocity(scene)

                ovf = scene.nbr_overflow
                if has_fluid:
                    nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                                 scene.active, cfg)
                    ovf = ovf | nbrs.overflow
                    arho = fops.continuity(scene, nbrs, kernel, fl, fl_bd)
                    ap = (fops.edac(scene, nbrs, kernel, nu_edac, c0, fl,
                                    fl_bd)
                          if edac else jnp.zeros_like(arho))
                    if has_rigid:
                        arho = arho + fops.continuity(scene, nbrs, kernel,
                                                      fl, rb, fsi=True)
                        if edac:
                            ap = ap + fops.edac(scene, nbrs, kernel,
                                                nu_edac, c0, fl, rb,
                                                fsi=True)
                    scene = scene.replace(arho=jnp.where(fl, arho, 0.0),
                                          ap=jnp.where(fl, ap, 0.0))

                if has_fluid:
                    rho_new = scene.rho + dt * scene.arho
                    upd = dict(
                        x=jnp.where(fl, scene.x + dt * scene.u, scene.x),
                        y=jnp.where(fl, scene.y + dt * scene.v, scene.y),
                        z=jnp.where(fl, scene.z + dt * scene.w, scene.z),
                        rho=jnp.where(fl, rho_new, scene.rho),
                        vol=jnp.where(fl, scene.m / rho_new, scene.vol),
                    )
                    if edac:
                        upd["p"] = jnp.where(fl, scene.p + dt * scene.ap,
                                             scene.p)
                    scene = scene.replace(**upd)
                if has_rigid:
                    scene = _body_drift(scene, dt, two_d=False)
                    scene = _particles_from_body_position(scene)

                nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                             scene.active, cfg)
                ovf = ovf | nbrs.overflow
                if has_fluid:
                    scene = fluid_stage2(scene, nbrs, fl, bd, rb, fl_bd)
                if has_rigid:
                    extra = None
                    if has_fluid:
                        def extra(sc, nb):
                            return fops.force_on_rigid_body_due_to_fluid(
                                sc, nb, kernel, rb, fl)
                    scene = rigid_contact_force_eval(scene, nbrs, kernel,
                                                     params, dt,
                                                     extra_force=extra)
                scene = scene.replace(nbr_overflow=ovf)

                if has_fluid:
                    scene = scene.replace(
                        u=jnp.where(fl, scene.u + 0.5 * dt * scene.au,
                                    scene.u),
                        v=jnp.where(fl, scene.v + 0.5 * dt * scene.av,
                                    scene.v),
                        w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw,
                                    scene.w),
                    )
                if has_rigid:
                    scene = _body_half_kick(scene, dt, two_d=False)
                    scene = _particles_from_body_velocity(scene)
                return scene

            return step_kdk

        @jax.jit
        def step(scene: Scene, dt):
            fl = scene.is_fluid & scene.active
            bd = scene.is_static_boundary & scene.active
            rb = scene.is_rigid & scene.active
            fl_bd = fl | bd

            nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                         scene.active, cfg)

            # ---- stage-1 equations: fluid density / pressure rates ----
            if has_fluid:
                arho = fops.continuity(scene, nbrs, kernel, fl, fl_bd)
                ap = (fops.edac(scene, nbrs, kernel, nu_edac, c0, fl, fl_bd)
                      if edac else jnp.zeros_like(arho))
                if has_rigid:
                    arho = arho + fops.continuity(scene, nbrs, kernel, fl,
                                                  rb, fsi=True)
                    if edac:
                        ap = ap + fops.edac(scene, nbrs, kernel, nu_edac,
                                            c0, fl, rb, fsi=True)
                scene = scene.replace(arho=arho, ap=ap)

            # ---- stepper stage 1 ----
            if has_fluid:
                scene = scene.replace(
                    u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                    v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                    w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
                )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)

            # ---- stage-2 equations ----
            if has_fluid:
                scene = fluid_stage2(scene, nbrs, fl, bd, rb, fl_bd)

            if has_rigid:
                extra = None
                if has_fluid:
                    def extra(sc, nb):
                        return fops.force_on_rigid_body_due_to_fluid(
                            sc, nb, kernel, rb, fl)
                scene = rigid_contact_force_eval(scene, nbrs, kernel,
                                                 params, dt,
                                                 extra_force=extra)

            scene = scene.replace(
                nbr_overflow=scene.nbr_overflow | nbrs.overflow)

            # ---- stepper stage 2 (drift) ----
            if has_fluid:
                rho_new = scene.rho + dt * scene.arho
                upd = dict(
                    x=jnp.where(fl, scene.x + dt * scene.u, scene.x),
                    y=jnp.where(fl, scene.y + dt * scene.v, scene.y),
                    z=jnp.where(fl, scene.z + dt * scene.w, scene.z),
                    rho=jnp.where(fl, rho_new, scene.rho),
                    vol=jnp.where(fl, scene.m / rho_new, scene.vol),
                )
                if edac:
                    upd["p"] = jnp.where(fl, scene.p + dt * scene.ap,
                                         scene.p)
                scene = scene.replace(**upd)
            if has_rigid:
                scene = _body_drift(scene, dt, two_d=False)
                scene = _particles_from_body_position(scene)

            # ---- stepper stage 3 (second half-kick) ----
            if has_fluid:
                scene = scene.replace(
                    u=jnp.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
                    v=jnp.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
                    w=jnp.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w),
                )
            if has_rigid:
                scene = _body_half_kick(scene, dt, two_d=False)
                scene = _particles_from_body_velocity(scene)
            return scene

        return step

"""DEM granular scheme: LVC contact + velocity-Verlet stepping.

Re-design of the reference's ``DEMScheme`` (``code/dem.py:628-828``) and
``DEMStep`` (:595-625) under the GTVF stage ordering (half-kick ->
force eval -> drift -> half-kick; the reference's stage-1 equation list
is empty, :714).

Per-particle state: translational + angular velocity (wx/wy/wz), torque
accumulators, scalar moment of inertia ``moi``, and the fixed-slot
tangential contact table (see ``ops.dem``).  Per-entity material tables
``dem_kn/dem_kt/dem_alpha/dem_mu`` are indexed by source dem id exactly
like the reference's per-array constant vectors (``d_kn[s_dem_id]``,
``code/dem.py:112,164,181``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import dem as dops
from ..ops import neighbors as nbmod
from ..ops.kernels import get_kernel
from ..state.scene import Scene
from .base import Scheme


class DEMScheme(Scheme):
    name = "dem"

    def __init__(self, granular_particles, boundaries, kn=1e5, en=0.5,
                 integrator="gtvf", dim=2, gx=0.0, gy=0.0, gz=0.0,
                 kernel_choice="cubic", kernel_factor=3,
                 contact_model="LVCDisplacement",
                 max_tng_contacts_limit=6, mu=0.5):
        self.granular_particles = list(granular_particles or [])
        self.boundaries = list(boundaries or [])
        self.dim = dim
        self.kn = kn
        self.en = en
        self.mu = mu
        self.gx, self.gy, self.gz = gx, gy, gz
        self.contact_model = contact_model
        self.kernel_name = "cubic"
        self.max_tng_contacts_limit = int(max_tng_contacts_limit)
        self.dt = None
        self.tf = None
        self.pfreq = 100
        self._nbr_cfg: Optional[nbmod.NeighborConfig] = None
        self._cell_cfg = None

    def add_user_options(self, group):
        group.add_argument("--contact-model", dest="contact_model",
                           default="LVCDisplacement",
                           choices=["LVCDisplacement", "LVCForce"],
                           help="DEM contact model")

    def consume_user_options(self, options):
        if hasattr(options, "contact_model"):
            self.contact_model = options.contact_model

    def derived_lvc_constants(self):
        """kt = 2/7 kn; alpha from restitution (reference ``LVCForce``
        :300-309 — the displacement model reads per-entity tables, which
        default to these)."""
        log_en = np.log(self.en)
        alpha = 2.0 * np.sqrt(self.kn) * abs(log_en) / np.sqrt(
            np.pi**2 + log_en**2)
        return 2.0 / 7.0 * self.kn, alpha

    def setup(self, scene: Scene, dem_kn=None, dem_kt=None, dem_alpha=None,
              dem_mu=None) -> Scene:
        """Attach DEM state (reference ``setup_properties`` :785-825)."""
        fdt = config.float_dtype()
        n = scene.n
        L = self.max_tng_contacts_limit
        n_ent = scene.meta.total_no_bodies
        kt_d, alpha_d = self.derived_lvc_constants()

        def tab(v, default):
            if v is None:
                return jnp.full(n_ent, default, fdt)
            return jnp.asarray(np.broadcast_to(np.asarray(v, float), (n_ent,)),
                               fdt)

        fields = dict(
            fx=jnp.zeros(n, fdt), fy=jnp.zeros(n, fdt), fz=jnp.zeros(n, fdt),
            wx=jnp.zeros(n, fdt), wy=jnp.zeros(n, fdt), wz=jnp.zeros(n, fdt),
            torx=jnp.zeros(n, fdt), tory=jnp.zeros(n, fdt),
            torz=jnp.zeros(n, fdt),
            tng_idx=jnp.full((n, L), -1, jnp.int32),
            tng_idx_dem_id=jnp.full((n, L), -1, jnp.int32),
            total_tng_contacts=jnp.zeros(n, jnp.int32),
            dem_kn=tab(dem_kn, self.kn),
            dem_kt=tab(dem_kt, kt_d),
            dem_alpha=tab(dem_alpha, alpha_d),
            dem_mu=tab(dem_mu, self.mu),
            nbr_overflow=jnp.zeros((), bool),
        )
        if self.contact_model == "LVCDisplacement":
            for k in ("tng_x", "tng_y", "tng_z"):
                fields[k] = jnp.zeros((n, L), fdt)
        else:
            for k in ("tng_fx", "tng_fy", "tng_fz"):
                fields[k] = jnp.zeros((n, L), fdt)
        if "moi" not in scene:
            # sphere default: 2/5 m r^2
            moi = 0.4 * np.asarray(scene.m) * np.asarray(scene.rad_s) ** 2
            fields["moi"] = jnp.asarray(moi, fdt)
        scene = scene.with_fields(**fields)
        kernel = get_kernel(self.kernel_name, self.dim)
        self._nbr_cfg = self.neighbor_config(scene, kernel.radius_scale)
        return scene

    def cell_config(self, scene: Scene):
        if self._cell_cfg is None:
            from ..ops import cellpairs as cellmod
            kernel = get_kernel(self.kernel_name, self.dim)
            cutoff = float(kernel.radius_scale * np.asarray(scene.h).max())
            self._cell_cfg = cellmod.config_from_positions(
                np.asarray(scene.x), np.asarray(scene.y),
                np.asarray(scene.z), cutoff, self.dim,
                capacity_boost=self.capacity_boost)
        return self._cell_cfg

    def make_step(self, scene: Scene):
        if self._nbr_cfg is None:
            kernel = get_kernel(self.kernel_name, self.dim)
            self._nbr_cfg = self.neighbor_config(scene, kernel.radius_scale)
        cfg = self._nbr_cfg
        use_cell = self.engine == "cell"
        cell_cfg = self.cell_config(scene) if use_cell else None
        gx, gy, gz = self.gx, self.gy, self.gz
        displacement = self.contact_model == "LVCDisplacement"
        kn, mu, en = self.kn, self.mu, self.en
        # only granular particles move (boundaries static)
        mobile_groups = set(self.granular_particles)
        mob = np.zeros(scene.n, bool)
        for g in scene.meta.groups:
            if g.name in mobile_groups:
                mob[g.start:g.stop] = True
        mobile = jnp.asarray(mob)

        @jax.jit
        def step(scene: Scene, dt):
            # DEMStep stage1: half-kick with stored forces (dem.py:596-607)
            half = 0.5 * dt
            m_inv = 1.0 / scene.m
            I_inv = 1.0 / scene.moi
            sel = lambda new, old: jnp.where(mobile, new, old)
            scene = scene.replace(
                u=sel(scene.u + half * scene.fx * m_inv, scene.u),
                v=sel(scene.v + half * scene.fy * m_inv, scene.v),
                w=sel(scene.w + half * scene.fz * m_inv, scene.w),
                wx=sel(scene.wx + half * scene.torx * I_inv, scene.wx),
                wy=sel(scene.wy + half * scene.tory * I_inv, scene.wy),
                wz=sel(scene.wz + half * scene.torz * I_inv, scene.wz),
            )

            # stage-2 equations: prune table, body force, LVC contact
            if use_cell and displacement:
                from ..ops import cellpairs as cellmod
                from ..ops import dem_cell as dcops
                ti, td, ta, tb, tc, _ = dops.prune_contact_table(
                    scene, scene.tng_idx, scene.tng_idx_dem_id,
                    scene.tng_x, scene.tng_y, scene.tng_z)
                grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                               scene.active, cell_cfg)
                (cfx, cfy, cfz, tx_, ty_, tz_, ti, td, ta, tb, tc,
                 cnt) = dcops.lvc_displacement_cell(
                     scene, grid, cell_cfg, dt, ti, td, ta, tb, tc)
                scene = scene.replace(tng_idx=ti, tng_idx_dem_id=td,
                                      tng_x=ta, tng_y=tb, tng_z=tc,
                                      total_tng_contacts=cnt,
                                      nbr_overflow=(scene.nbr_overflow
                                                    | grid.overflow))
            elif use_cell:
                from ..ops import cellpairs as cellmod
                from ..ops import dem_cell as dcops
                ti, td, ta, tb, tc, _ = dops.prune_contact_table(
                    scene, scene.tng_idx, scene.tng_idx_dem_id,
                    scene.tng_fx, scene.tng_fy, scene.tng_fz)
                grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z,
                                               scene.active, cell_cfg)
                (cfx, cfy, cfz, tx_, ty_, tz_, ti, td, ta, tb, tc,
                 cnt) = dcops.lvc_force_cell(
                     scene, grid, cell_cfg, dt, kn, mu, en,
                     ti, td, ta, tb, tc)
                scene = scene.replace(tng_idx=ti, tng_idx_dem_id=td,
                                      tng_fx=ta, tng_fy=tb, tng_fz=tc,
                                      total_tng_contacts=cnt,
                                      nbr_overflow=(scene.nbr_overflow
                                                    | grid.overflow))
            elif displacement:
                nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                             scene.active, cfg)
                ti, td, ta, tb, tc, _ = dops.prune_contact_table(
                    scene, scene.tng_idx, scene.tng_idx_dem_id,
                    scene.tng_x, scene.tng_y, scene.tng_z)
                (cfx, cfy, cfz, tx_, ty_, tz_, ti, td, ta, tb, tc,
                 cnt) = dops.lvc_displacement(scene, nbrs, dt, ti, td, ta,
                                              tb, tc)
                scene = scene.replace(
                    tng_idx=ti, tng_idx_dem_id=td,
                    tng_x=ta, tng_y=tb, tng_z=tc,
                    total_tng_contacts=cnt,
                    nbr_overflow=scene.nbr_overflow | nbrs.overflow)
            else:
                nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                             scene.active, cfg)
                ti, td, ta, tb, tc, _ = dops.prune_contact_table(
                    scene, scene.tng_idx, scene.tng_idx_dem_id,
                    scene.tng_fx, scene.tng_fy, scene.tng_fz)
                (cfx, cfy, cfz, tx_, ty_, tz_, ti, td, ta, tb, tc,
                 cnt) = dops.lvc_force(scene, nbrs, dt, kn, mu, en, ti, td,
                                       ta, tb, tc)
                scene = scene.replace(
                    tng_idx=ti, tng_idx_dem_id=td,
                    tng_fx=ta, tng_fy=tb, tng_fz=tc,
                    total_tng_contacts=cnt,
                    nbr_overflow=scene.nbr_overflow | nbrs.overflow)
            gmask = mobile & scene.active
            fx = jnp.where(gmask, scene.m * gx + cfx, 0.0)
            fy = jnp.where(gmask, scene.m * gy + cfy, 0.0)
            fz = jnp.where(gmask, scene.m * gz + cfz, 0.0)
            scene = scene.replace(
                fx=fx, fy=fy, fz=fz,
                torx=jnp.where(gmask, tx_, 0.0),
                tory=jnp.where(gmask, ty_, 0.0),
                torz=jnp.where(gmask, tz_, 0.0),
            )

            # stage2 drift (:609-612)
            sel = lambda new, old: jnp.where(mobile, new, old)
            scene = scene.replace(
                x=sel(scene.x + dt * scene.u, scene.x),
                y=sel(scene.y + dt * scene.v, scene.y),
                z=sel(scene.z + dt * scene.w, scene.z),
            )
            # stage3: second half-kick (:614-625)
            m_inv = 1.0 / scene.m
            I_inv = 1.0 / scene.moi
            scene = scene.replace(
                u=sel(scene.u + half * scene.fx * m_inv, scene.u),
                v=sel(scene.v + half * scene.fy * m_inv, scene.v),
                w=sel(scene.w + half * scene.fz * m_inv, scene.w),
                wx=sel(scene.wx + half * scene.torx * I_inv, scene.wx),
                wy=sel(scene.wy + half * scene.tory * I_inv, scene.wy),
                wz=sel(scene.wz + half * scene.torz * I_inv, scene.wz),
            )
            return scene

        return step

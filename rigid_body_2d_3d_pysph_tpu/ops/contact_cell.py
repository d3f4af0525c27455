"""Mofidi contact pipeline on the dense cell-block engine.

Same physics as ``ops.contact`` (reference Eq. 22/21/24,
``code/rigid_body_common.py:631-836``) but evaluated over cell blocks:
all pair quantities are dense ``[C, M, O*M]`` arithmetic with zero
per-element gathers in the hot loop (see ``ops.cellpairs``).  The final
per-slot force map (Eq. 24, ``contact.contact_force``) is layout-agnostic
and is reused unchanged.

Outputs are identical (to float tolerance) to the [N, K] path; the
equivalence is covered by tests/test_cell_engine.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .cellpairs import (CellGrid, CellGridConfig, gather_source_block,
                        map_over_cells, pack_fields, pack_rows, unpack)
from .kernels import Kernel

_BIG = 1.0e9

# Every einsum here runs at HIGHEST precision.  At DEFAULT, XLA:GPU may
# run f32 matrix products in TF32 (10-bit mantissa): the one-hot
# SELECTION einsums would round picked source positions and lane-index
# tie-breaks (TF32 integers are exact only to 2048; the 3D spill grid
# has O*M > 2048 lanes), and the ACCUMULATION sums would lose ~3 decimal
# digits of the contact normals and distances.
_EXACT = jax.lax.Precision.HIGHEST

# packed f32 field order
_FX, _FY, _FZ, _FU, _FV, _FW, _FM, _FRHO, _FH, _FCFIB = range(10)
# packed i32 field order
_IDEM, _IRIGID, _IFLUID = range(3)

_F_SENT = [_BIG, _BIG, _BIG, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0]
_I_SENT = [-1, 0, 0]


def pack_scene(scene, grid: CellGrid, cfg: CellGridConfig):
    f = pack_fields(grid, cfg,
                    [scene.x, scene.y, scene.z, scene.u, scene.v, scene.w,
                     scene.m, scene.rho, scene.h,
                     scene.contact_force_is_boundary],
                    _F_SENT)
    i = pack_fields(grid, cfg,
                    [scene.dem_id, scene.is_rigid.astype(jnp.int32),
                     scene.is_fluid.astype(jnp.int32)],
                    _I_SENT)
    return f, i


def _pair_geom(qf, sf):
    """Pair displacement/distance: q [C,M,F], s [C,O,M,F] ->
    [C, M, OM] tensors."""
    C, O, M, F = sf.shape
    s = sf.reshape(C, 1, O * M, F)
    q = qf[:, :, None, :]
    xij = q[..., _FX] - s[..., _FX]
    yij = q[..., _FY] - s[..., _FY]
    zij = q[..., _FZ] - s[..., _FZ]
    rij = jnp.sqrt(xij * xij + yij * yij + zij * zij)
    hij = 0.5 * (q[..., _FH] + s[..., _FH])
    return s, xij, yij, zij, rij, hij


def contact_normals_cell(scene, grid: CellGrid, cfg: CellGridConfig,
                         kernel: Kernel, S: int, df, di):
    """Eq. 22 over cell blocks -> dense cfn [NC, M, 3] per slot arrays
    ([NC, M, S] each) + wij sums."""

    def block(start, qf, qi, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _F_SENT)
        si = gather_source_block(di, nbrs, cfg, _I_SENT)
        s, xij, yij, zij, rij, hij = _pair_geom(qf, sf)
        C, O, M, F = sf.shape
        si_f = si.reshape(C, 1, O * M, si.shape[-1])
        s_dem = si_f[..., _IDEM]
        q_dem = qi[:, :, None, _IDEM]
        gate = ((s[..., _FCFIB] == 1.0)
                & (s_dem != q_dem)
                & (si_f[..., _IFLUID] == 0)
                & (qi[:, :, None, _IRIGID] == 1)
                & (rij <= cfg.radius))
        wij = kernel.w(rij, hij)
        rinv = 1.0 / jnp.maximum(rij, 1e-300)
        tmp = qf[:, :, None, _FM] / qf[:, :, None, _FRHO] * rinv * wij
        tmp = jnp.where(gate, tmp, 0.0)

        # slot reduction as a one-hot contraction over the source lanes:
        # [C,M,OM,4] x [C,OM,S] -> [C,M,S,4] touches each [C,M,OM]
        # quantity once (a per-slot loop would re-stream
        # them S times from HBM)
        oh = (s_dem[:, 0, :, None]
              == jnp.arange(S, dtype=s_dem.dtype)[None, None, :]
              ).astype(tmp.dtype)  # [C, OM, S]
        quant = jnp.stack([tmp * xij, tmp * yij, tmp * zij, tmp * rij],
                          axis=-1)  # [C, M, OM, 4]
        return jnp.einsum("cmkq,cks->cmsq", quant, oh,
                          preferred_element_type=tmp.dtype,
                          precision=_EXACT)

    acc = map_over_cells(cfg, block, df, di, grid.nbr_slots)  # [NC,M,S,4]
    sx, sy, sz, sw = (acc[..., 0], acc[..., 1], acc[..., 2], acc[..., 3])
    has = sw > 1e-12
    inv_w = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
    mx, my, mz = sx * inv_w, sy * inv_w, sz * inv_w
    mag = jnp.sqrt(mx * mx + my * my + mz * mz)
    inv_m = jnp.where(has & (mag > 0), 1.0 / jnp.maximum(mag, 1e-300), 0.0)
    return mx * inv_m, my * inv_m, mz * inv_m, sw  # dense [NC, M, S]


def contact_distance_cell(scene, grid: CellGrid, cfg: CellGridConfig,
                          kernel: Kernel, S: int, df, di,
                          cfn_x_d, cfn_y_d, cfn_z_d, spacing0: float):
    """Eq. 21 over cell blocks (+ closest-source tracking)."""
    init_dist = 4.0 * spacing0
    cfn = jnp.stack([cfn_x_d, cfn_y_d, cfn_z_d], axis=-1)  # [NC, M, S, 3]

    def block(start, qf, qi, qcfn, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _F_SENT)
        si = gather_source_block(di, nbrs, cfg, _I_SENT)
        s, xij, yij, zij, rij, hij = _pair_geom(qf, sf)
        C, O, M, F = sf.shape
        si_f = si.reshape(C, 1, O * M, si.shape[-1])
        s_dem = si_f[..., _IDEM]
        gate = ((s[..., _FCFIB] == 1.0)
                & (s_dem != qi[:, :, None, _IDEM])
                & (si_f[..., _IFLUID] == 0)
                & (qi[:, :, None, _IRIGID] == 1)
                & (rij <= cfg.radius))
        wij = kernel.w(rij, hij)
        tmp = jnp.where(gate, qf[:, :, None, _FM] / qf[:, :, None, _FRHO]
                        * wij, 0.0)

        # numerator/denominator sums batched over slots via one-hot
        # contraction: num_s = n_s . sum_k t*xij_vec (the normal is a
        # per-(dest,slot) constant, so it factors out of the k-sum)
        oh = (s_dem[:, 0, :, None]
              == jnp.arange(S, dtype=s_dem.dtype)[None, None, :]
              ).astype(tmp.dtype)  # [C, OM, S]
        quant = jnp.stack([tmp, tmp * xij, tmp * yij, tmp * zij], -1)
        sums = jnp.einsum("cmkq,cks->cmsq", quant, oh,
                          preferred_element_type=tmp.dtype,
                          precision=_EXACT)  # [C,M,S,4]
        den = sums[..., 0]
        num = (qcfn[..., 0] * sums[..., 1] + qcfn[..., 1] * sums[..., 2]
               + qcfn[..., 2] * sums[..., 3])

        # closest source per slot: argmin + one-hot pick (einsum'd so each
        # source-field tensor is streamed once per slot, not six times)
        src6 = jnp.stack([s[..., _FX], s[..., _FY], s[..., _FZ],
                          s[..., _FU], s[..., _FV], s[..., _FW]],
                         -1)[:, 0]  # [C, OM, 6]
        rg = jnp.where(gate, rij, _BIG)
        lane = jax.lax.broadcasted_iota(jnp.int32, rg.shape, 2)
        mind, srcs = [], []
        for s_id in range(S):
            r_s = jnp.where(s_dem == s_id, rg, _BIG)
            k_star = jnp.argmin(r_s, axis=-1)           # [C, M]
            sel = (lane == k_star[..., None]).astype(tmp.dtype)
            r_star = jnp.min(r_s, axis=-1)
            found = (r_star < init_dist)[..., None]
            mind.append(jnp.minimum(r_star, init_dist))
            picked = jnp.einsum("cmk,ckf->cmf", sel, src6,
                                preferred_element_type=tmp.dtype,
                                precision=_EXACT)
            srcs.append(jnp.where(found, picked, 0.0))
        return (num, den, jnp.stack(mind, -1),
                jnp.stack(srcs, 2))  # [C,M,S], ..., [C,M,S,6]

    num, den, mind, srcs = map_over_cells(
        cfg, block, df, di, cfn, grid.nbr_slots)
    has = den > 1e-12
    dist = jnp.where(has, num / jnp.where(has, den, 1.0), 0.0)
    return dict(
        contact_force_dist=dist,
        closest_point_dist_to_source=mind,
        x_source=srcs[..., 0], y_source=srcs[..., 1], z_source=srcs[..., 2],
        vx_source=srcs[..., 3], vy_source=srcs[..., 4],
        vz_source=srcs[..., 5],
    )


def contact_pipeline_cell(scene, grid: CellGrid, cfg: CellGridConfig,
                          kernel: Kernel):
    """Both pair passes; returns ([N,S] cfn_x/y/z, wij, dist_info dict)
    in ORIGINAL particle order, ready for ``contact.contact_force``."""
    S = scene.meta.total_no_bodies
    n = scene.n
    df, di = pack_scene(scene, grid, cfg)
    cfx_d, cfy_d, cfz_d, sw_d = contact_normals_cell(
        scene, grid, cfg, kernel, S, df, di)
    dinfo_d = contact_distance_cell(
        scene, grid, cfg, kernel, S, df, di, cfx_d, cfy_d, cfz_d,
        scene.meta.spacing0)
    up = lambda d, fill=0.0: unpack(grid, cfg, d, n, fill)
    dinfo = {k: up(v) for k, v in dinfo_d.items()}
    return up(cfx_d), up(cfy_d), up(cfz_d), up(sw_d), dinfo


# ---------------------------------------------------------------------------
# fused single-pass pipeline (the cell engine's step)
# ---------------------------------------------------------------------------

def contact_sums_fused(scene, grid: CellGrid, cfg: CellGridConfig,
                       kernel: Kernel, S: int, df, di,
                       spacing0: float):
    """Eq. 22 + Eq. 21 + closest-point in ONE pass over source blocks.

    The two reference pair loops (``rigid_body_common.py:631-723`` and
    ``:726-836``) share their gate, pair geometry and kernel evaluation;
    and the distance numerator's normal factors out of the neighbor sum
    (``num_s = n_s . sum_k t2*xij_vec``), so both reduce to SEVEN per-slot
    sums of one pass:

        t1*xij, t1*yij, t1*zij   (Eq. 22 normal sums; t1 = m/rho * W/r)
        t2,     t2*xij, t2*yij, t2*zij  (Eq. 21 sums;  t2 = m/rho * W)

    with ``sum(t1*rij) == sum(t2)`` (the normals' wij-norm equals the
    distance denominator).  Closest-point tracking replaces the per-slot
    argmin/pick loop with: per-slot min (elementwise loop), a one-hot
    broadcast of the min back to lanes, a first-match mask, and ONE
    [C,M,OM]x[C,OM,S*6] contraction for the source pick.

    Returns dense per-slot arrays ([NC,M,S]-shaped):
    (cfn_x, cfn_y, cfn_z, wij_sum, dist, min_dist, srcs[...,6]).
    """
    init_dist = 4.0 * spacing0

    def block(start, qf, qi, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _F_SENT)
        si = gather_source_block(di, nbrs, cfg, _I_SENT)
        s, xij, yij, zij, rij, hij = _pair_geom(qf, sf)
        C, O, M, F = sf.shape
        si_f = si.reshape(C, 1, O * M, si.shape[-1])
        s_dem = si_f[..., _IDEM]
        gate = ((s[..., _FCFIB] == 1.0)
                & (s_dem != qi[:, :, None, _IDEM])
                & (si_f[..., _IFLUID] == 0)
                & (qi[:, :, None, _IRIGID] == 1)
                & (rij <= cfg.radius))
        wij = kernel.w(rij, hij)
        rinv = 1.0 / jnp.maximum(rij, 1e-300)
        t1 = jnp.where(gate,
                       qf[:, :, None, _FM] / qf[:, :, None, _FRHO]
                       * rinv * wij, 0.0)
        t2 = t1 * rij  # == m/rho * W on gated pairs

        oh = (s_dem[:, 0, :, None]
              == jnp.arange(S, dtype=s_dem.dtype)[None, None, :]
              ).astype(t1.dtype)  # [C, OM, S]
        quant = jnp.stack([t1 * xij, t1 * yij, t1 * zij,
                           t2, t2 * xij, t2 * yij, t2 * zij],
                          axis=-1)  # [C, M, OM, 7]
        sums = jnp.einsum("cmkq,cks->cmsq", quant, oh,
                          preferred_element_type=t1.dtype,
                          precision=_EXACT)  # [C,M,S,7]

        # ---- closest source per slot -------------------------------------
        r_g = jnp.where(gate, rij, _BIG)  # [C, M, OM]
        mins = [jnp.min(jnp.where(s_dem == s_id, r_g, _BIG), axis=-1)
                for s_id in range(S)]
        min_r = jnp.stack(mins, axis=-1)  # [C, M, S]
        # broadcast each lane's slot-min back to the lane (one-hot matmul;
        # sentinel lanes have all-zero one-hot -> min_b = 0 != r_g)
        min_b = jnp.einsum("cms,cks->cmk", min_r, oh,
                           preferred_element_type=t1.dtype,
                           precision=_EXACT)
        pick = gate & (r_g <= min_b)
        # ties (equal r within a slot): keep the lowest lane, like the
        # reference's sequential scan (:811-818).  The tie-break must be
        # slot-local, so select the min picked lane per slot and
        # broadcast it back through the same one-hot contraction.
        lane = jax.lax.broadcasted_iota(
            jnp.int32, r_g.shape, r_g.ndim - 1).astype(t1.dtype)
        lane_mins = [jnp.min(jnp.where(pick & (s_dem == s_id), lane, _BIG),
                             axis=-1) for s_id in range(S)]
        lane_sel = jnp.stack(lane_mins, axis=-1)  # [C, M, S]
        lane_b = jnp.einsum("cms,cks->cmk", lane_sel, oh,
                            preferred_element_type=t1.dtype,
                            precision=_EXACT)
        pickf = (pick & (lane == lane_b)).astype(t1.dtype)  # [C, M, OM]

        src6 = jnp.stack([s[..., _FX], s[..., _FY], s[..., _FZ],
                          s[..., _FU], s[..., _FV], s[..., _FW]],
                         -1)[:, 0]  # [C, OM, 6]
        A = (oh[:, :, :, None] * src6[:, :, None, :]).reshape(
            C, O * M, S * 6)  # slot-separated source fields
        srcs = jnp.einsum("cmk,ckq->cmq", pickf, A,
                          preferred_element_type=t1.dtype,
                          precision=_EXACT
                          ).reshape(C, M, S, 6)
        return sums, min_r, srcs

    sums, min_r, srcs = map_over_cells(
        cfg, block, df, di, grid.nbr_slots)

    sx, sy, sz = sums[..., 0], sums[..., 1], sums[..., 2]
    sw = sums[..., 3]  # == sum(t1*rij) == sum(t2) (den)
    has = sw > 1e-12
    inv_w = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
    mx, my, mz = sx * inv_w, sy * inv_w, sz * inv_w
    mag = jnp.sqrt(mx * mx + my * my + mz * mz)
    inv_m = jnp.where(has & (mag > 0), 1.0 / jnp.maximum(mag, 1e-300), 0.0)
    cfn_x, cfn_y, cfn_z = mx * inv_m, my * inv_m, mz * inv_m

    num = (cfn_x * sums[..., 4] + cfn_y * sums[..., 5]
           + cfn_z * sums[..., 6])
    dist = jnp.where(has, num / jnp.where(has, sw, 1.0), 0.0)

    found = min_r < init_dist
    mind = jnp.minimum(min_r, init_dist)
    srcs = jnp.where(found[..., None], srcs, 0.0)
    return cfn_x, cfn_y, cfn_z, sw, dist, mind, srcs


def contact_pipeline_cell_fused(scene, grid: CellGrid, cfg: CellGridConfig,
                                kernel: Kernel):
    """Fused-pass variant of :func:`contact_pipeline_cell`: one pass over
    source blocks, one stacked unpack (13 outputs in a single row gather
    instead of 13 narrow ones).  Numerically equivalent to the two-pass
    engine (tests/test_cell_engine.py)."""
    S = scene.meta.total_no_bodies
    n = scene.n
    df, di = pack_scene(scene, grid, cfg)
    cfn_x, cfn_y, cfn_z, sw, dist, mind, srcs = contact_sums_fused(
        scene, grid, cfg, kernel, S, df, di, scene.meta.spacing0)

    stacked = jnp.concatenate(
        [jnp.stack([cfn_x, cfn_y, cfn_z, sw, dist, mind], axis=-1),
         srcs], axis=-1)  # [NC, M, S, 12]
    flat = unpack(grid, cfg,
                  stacked.reshape(cfg.NC_max, cfg.M, S * 12), n, 0.0)
    out = flat.reshape(n, S, 12)
    dinfo = dict(
        contact_force_dist=out[..., 4],
        closest_point_dist_to_source=out[..., 5],
        x_source=out[..., 6], y_source=out[..., 7], z_source=out[..., 8],
        vx_source=out[..., 9], vy_source=out[..., 10],
        vz_source=out[..., 11],
    )
    return out[..., 0], out[..., 1], out[..., 2], out[..., 3], dinfo

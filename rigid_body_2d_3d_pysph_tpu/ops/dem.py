"""Granular DEM: Luding linear viscoelastic contact (LVC) with Coulomb
friction and persistent per-pair tangential history.

Re-design of the reference's ``code/dem.py``:

* ``LVCDisplacement``                         :35-205  (tangential spring
  stores *displacement*)
* ``UpdateTangentialContactsLVCDisplacement`` :208-293 (contact-table
  prune)
* ``LVCForce`` / ``UpdateTangentialContactsLVCForce`` :296-592 (variant
  storing the tangential *force*; unreachable through the reference
  scheme because of a duplicated ``elif`` condition at :729/:750 — kept
  here as a selectable model)

Contact-table design: the reference keeps a compacting list of (source
particle index, source dem id) per destination with swap-deletion
(:251-288).  Because this framework never reorders particles (the
neighbor grid permutes internally only), source indices are stable, so
the table becomes a fixed ``[N, L]`` slot array keyed by source index:
pruning frees slots in place; new contacts fill the lowest free slots.
Physics is identical — slot order never enters the force law.

Deviations (documented):
* The reference never zeroes the particle torque accumulators (no
  equation initializes ``torx/tory/torz``; the shipped repo has no DEM
  app to surface this).  We reset torque at the start of each force
  evaluation — the only consistent semantic.
* The reference's ``LVCForce`` Coulomb check compares a *squared*
  magnitude against an unsquared one (:485-489, missing sqrt).  We use
  the mathematically intended comparison.
"""

from __future__ import annotations

import jax.numpy as jnp

from .neighbors import NeighborList
from .pairs import pair_data


def prune_contact_table(scene, tng_idx, tng_dem, tng_a, tng_b, tng_c,
                        row_of_gid=None):
    """Free slots whose pair no longer overlaps (reference
    ``initialize_pair`` :209-293).  Returns updated table + counts.

    ``row_of_gid``: optional [G+1] gid -> local-row translation for the
    slab-sharded path, whose tables key on persistent global ids; a gid
    not present locally maps to row n (=> slot freed — an overlapping
    partner is always within the halo, so absence means separation)."""
    live = tng_idx >= 0
    if row_of_gid is None:
        j = jnp.clip(tng_idx, 0, scene.n - 1)
    else:
        row = row_of_gid[jnp.clip(tng_idx, 0, row_of_gid.shape[0] - 1)]
        live = live & (row < scene.n)
        j = jnp.clip(row, 0, scene.n - 1)
    dx = scene.x[:, None] - scene.x[j]
    dy = scene.y[:, None] - scene.y[j]
    dz = scene.z[:, None] - scene.z[j]
    rij = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    overlap = scene.rad_s[:, None] + scene.rad_s[j] - rij
    keep = live & (overlap > 0.0) & (tng_dem == scene.dem_id[j])
    tng_idx = jnp.where(keep, tng_idx, -1)
    tng_dem = jnp.where(keep, tng_dem, -1)
    tng_a = jnp.where(keep, tng_a, 0.0)
    tng_b = jnp.where(keep, tng_b, 0.0)
    tng_c = jnp.where(keep, tng_c, 0.0)
    count = jnp.sum(keep, axis=1).astype(jnp.int32)
    return tng_idx, tng_dem, tng_a, tng_b, tng_c, count


def _match_slots(tng_idx, tng_dem, j, dem_j):
    """[N,K] pair -> slot index in [N,L] where (idx, dem) matches; -1 if
    absent (the reference's linear search :129-137)."""
    # [N, K, L] comparisons; L is small (reference default limit 6-30)
    eq = (tng_idx[:, None, :] == j[:, :, None]) & (
        tng_dem[:, None, :] == dem_j[:, :, None]
    )
    found = jnp.any(eq, axis=2)
    slot = jnp.argmax(eq, axis=2)
    return found, jnp.where(found, slot, -1)


def _allocate_slots(free_mask, new_mask):
    """Assign the r-th new contact of each row to its r-th free slot.
    Returns [N,K] slot ids (-1 if table full -> contact dropped).

    Formulated as a dense [R, K, L] one-hot match (L is the small
    contact-table width): no scatter, so the result does not depend on
    the order in which updates land."""
    L = free_mask.shape[1]
    free_rank = jnp.cumsum(free_mask.astype(jnp.int32), axis=1) - 1
    n_free = jnp.sum(free_mask, axis=1)
    new_rank = jnp.cumsum(new_mask.astype(jnp.int32), axis=1) - 1
    ok = new_mask & (new_rank < n_free[:, None])
    match = (free_mask[:, None, :]
             & (free_rank[:, None, :] == new_rank[:, :, None]))  # [R,K,L]
    slot = jnp.sum(
        jnp.where(match, jnp.arange(L, dtype=jnp.int32), 0), axis=2)
    return jnp.where(ok, slot, -1)


def lvc_displacement_core(q, s, xij, yij, zij, rij, cand, j, dem_j, dt,
                          kn, kt, alpha, mu,
                          tng_idx, tng_dem, tng_x, tng_y, tng_z):
    """Layout-agnostic LVC-displacement pair pass (reference :44-205).

    ``q``: dict of [R, 1] query columns (u,v,w,wx,wy,wz,rad,m);
    ``s``: dict of [R, K] source fields (same keys); ``cand``: [R, K]
    candidate validity (self-pairs already excluded); material arrays
    [R, K] gathered by source dem id.  Shared by the [N, K] neighbor-list
    engine and the dense cell engine (rows = flattened cell lanes).

    Returns per-pair force/torque sums [R] + the updated contact table.
    """
    overlap = q["rad"] + s["rad"] - rij
    gate = cand & (rij > 0) & (overlap > 0)

    rinv = 1.0 / jnp.maximum(rij, 1e-300)
    nx, ny, nz = xij * rinv, yij * rinv, zij * rinv

    # contact-point velocities incl. rotation (:73-91)
    a_i = q["rad"] - overlap / 2.0
    a_j = s["rad"] - overlap / 2.0
    vi_x = q["u"] + (q["wy"] * nz - q["wz"] * ny) * a_i
    vi_y = q["v"] + (q["wz"] * nx - q["wx"] * nz) * a_i
    vi_z = q["w"] + (q["wx"] * ny - q["wy"] * nx) * a_i
    vj_x = s["u"] + (-s["wy"] * nz + s["wz"] * ny) * a_j
    vj_y = s["v"] + (-s["wz"] * nx + s["wx"] * nz) * a_j
    vj_z = s["w"] + (-s["wx"] * ny + s["wy"] * nx) * a_j
    vij_x, vij_y, vij_z = vi_x - vj_x, vi_y - vj_y, vi_z - vj_z
    vdotn = vij_x * nx + vij_y * ny + vij_z * nz
    vt_x = vij_x - vdotn * nx
    vt_y = vij_y - vdotn * ny
    vt_z = vij_z - vdotn * nz

    m_eff = q["m"] * s["m"] / (q["m"] + s["m"])
    eta_n = alpha * jnp.sqrt(m_eff)

    fn = kn * overlap - eta_n * vdotn  # (:112)
    fn_x, fn_y, fn_z = fn * nx, fn * ny, fn * nz

    # --- tangential history ------------------------------------------------
    found, slot_found = _match_slots(tng_idx, tng_dem, j, dem_j)
    found &= gate
    new_mask = gate & ~found
    free = tng_idx < 0
    slot_new = _allocate_slots(free, new_mask)

    R = j.shape[0]
    rows = jnp.broadcast_to(jnp.arange(R)[:, None], j.shape)

    # spring state of found pairs, projected onto the current plane (:156-161)
    sf = jnp.clip(slot_found, 0, tng_x.shape[1] - 1)
    sx = jnp.where(found, tng_x[rows, sf], 0.0)
    sy = jnp.where(found, tng_y[rows, sf], 0.0)
    sz = jnp.where(found, tng_z[rows, sf], 0.0)
    sdotn = sx * nx + sy * ny + sz * nz
    sx, sy, sz = sx - sdotn * nx, sy - sdotn * ny, sz - sdotn * nz

    ft_x = -kt * sx - eta_n * vt_x
    ft_y = -kt * sy - eta_n * vt_y
    ft_z = -kt * sz - eta_n * vt_z
    ft_magn = jnp.sqrt(ft_x**2 + ft_y**2 + ft_z**2)
    has_t = ft_magn > 1e-12
    inv_ft = jnp.where(has_t, 1.0 / jnp.maximum(ft_magn, 1e-300), 0.0)
    tx, ty, tz = ft_x * inv_ft, ft_y * inv_ft, ft_z * inv_ft

    fn_mu = mu * fn
    slip = ft_magn > fn_mu
    # saturated: force capped, spring rescaled (:183-192); else spring grows
    ft_x = jnp.where(slip, fn_mu * tx, ft_x)
    ft_y = jnp.where(slip, fn_mu * ty, ft_y)
    ft_z = jnp.where(slip, fn_mu * tz, ft_z)
    kt_inv = 1.0 / jnp.where(kt > 0, kt, 1.0)
    new_sx = jnp.where(slip, -kt_inv * (fn_mu * tx + eta_n * vt_x),
                       sx + vt_x * dt)
    new_sy = jnp.where(slip, -kt_inv * (fn_mu * ty + eta_n * vt_y),
                       sy + vt_y * dt)
    new_sz = jnp.where(slip, -kt_inv * (fn_mu * tz + eta_n * vt_z),
                       sz + vt_z * dt)

    # new contacts contribute no tangential force this step (:140-148)
    ft_x = jnp.where(found, ft_x, 0.0)
    ft_y = jnp.where(found, ft_y, 0.0)
    ft_z = jnp.where(found, ft_z, 0.0)

    # --- write back table --------------------------------------------------
    # found pairs: updated spring; new pairs: register with zero spring.
    # Scatter-free: each (row, slot) has at most one contributing pair
    # (candidate lists are duplicate-free), so a per-slot masked K-sum
    # reproduces the scatter exactly, in a fixed summation order.
    Lc = tng_x.shape[1]
    sfl = jnp.where(found, sf, -1)
    snl = slot_new  # already -1 where unallocated

    def slot_write(tab, val_found, val_new):
        cols = []
        for l in range(Lc):
            m_f = sfl == l
            m_n = snl == l
            v = jnp.where(jnp.any(m_n, axis=1),
                          jnp.sum(jnp.where(m_n, val_new, 0), axis=1,
                                  dtype=tab.dtype),
                          tab[:, l])
            v = jnp.where(jnp.any(m_f, axis=1),
                          jnp.sum(jnp.where(m_f, val_found, 0), axis=1,
                                  dtype=tab.dtype),
                          v)
            cols.append(v)
        return jnp.stack(cols, axis=1)

    zero = jnp.zeros_like(new_sx)
    tng_x = slot_write(tng_x, jnp.where(found, new_sx, 0.0), zero)
    tng_y = slot_write(tng_y, jnp.where(found, new_sy, 0.0), zero)
    tng_z = slot_write(tng_z, jnp.where(found, new_sz, 0.0), zero)

    def slot_write_new(tab, val_new):
        cols = []
        for l in range(Lc):
            m_n = snl == l
            cols.append(jnp.where(
                jnp.any(m_n, axis=1),
                jnp.sum(jnp.where(m_n, val_new, 0), axis=1,
                        dtype=tab.dtype), tab[:, l]))
        return jnp.stack(cols, axis=1)

    tng_idx = slot_write_new(tng_idx, j.astype(jnp.int32))
    tng_dem = slot_write_new(tng_dem, dem_j.astype(jnp.int32))

    gsum = lambda v: jnp.sum(jnp.where(gate, v, 0.0), axis=1)
    fx = gsum(fn_x + ft_x)
    fy = gsum(fn_y + ft_y)
    fz = gsum(fn_z + ft_z)
    # torque = (n x ft) * a_i (:203-205)
    torx = gsum((ny * ft_z - nz * ft_y) * a_i)
    tory = gsum((nz * ft_x - nx * ft_z) * a_i)
    torz = gsum((nx * ft_y - ny * ft_x) * a_i)
    count = jnp.sum(tng_idx >= 0, axis=1).astype(jnp.int32)
    return (fx, fy, fz, torx, tory, torz,
            tng_idx, tng_dem, tng_x, tng_y, tng_z, count)


def _material_rows(dem_j, table):
    """table[dem_j] without per-element gathers: the entity count is tiny
    and static, so a where-accumulate loop stays on the VPU."""
    out = jnp.zeros(dem_j.shape, table.dtype)
    for e in range(table.shape[0]):
        out = jnp.where(dem_j == e, table[e], out)
    return out


def lvc_displacement(scene, nbrs: NeighborList, dt,
                     tng_idx, tng_dem, tng_x, tng_y, tng_z):
    """LVC force with tangential-displacement springs (reference :44-205)
    on the padded [N, K] neighbor-list engine.

    Per-entity material tables (indexed by SOURCE dem id, as the
    reference's ``d_kn[s_dem_id]`` etc.): scene fields ``dem_kn, dem_kt,
    dem_alpha, dem_mu`` of length >= max dem id + 1.

    Returns (fx, fy, fz, torx, tory, torz, new table arrays).
    """
    pd = pair_data(scene, nbrs)
    j = pd.j
    not_self = j != jnp.arange(scene.n)[:, None]
    cand = pd.mask & not_self
    dem_j = scene.dem_id[j]
    q = dict(u=scene.u[:, None], v=scene.v[:, None], w=scene.w[:, None],
             wx=scene.wx[:, None], wy=scene.wy[:, None],
             wz=scene.wz[:, None], rad=scene.rad_s[:, None],
             m=scene.m[:, None])
    s = dict(u=scene.u[j], v=scene.v[j], w=scene.w[j],
             wx=scene.wx[j], wy=scene.wy[j], wz=scene.wz[j],
             rad=scene.rad_s[j], m=scene.m[j])
    return lvc_displacement_core(
        q, s, pd.xij, pd.yij, pd.zij, pd.rij, cand, j, dem_j, dt,
        scene.dem_kn[dem_j], scene.dem_kt[dem_j],
        scene.dem_alpha[dem_j], scene.dem_mu[dem_j],
        tng_idx, tng_dem, tng_x, tng_y, tng_z)


def lvc_force(scene, nbrs: NeighborList, dt, kn: float, mu: float, en: float,
              tng_idx, tng_dem, tng_fx, tng_fy, tng_fz):
    """LVC with tangential-force springs (reference :296-505).  Scalar
    material constants (kn, mu, en) as in ``LVCForce.__init__`` :300-309:
    kt = 2/7 kn, alpha = 2 sqrt(kn) |ln en| / sqrt(pi^2 + ln^2 en)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    not_self = j != jnp.arange(scene.n)[:, None]
    cand = pd.mask & not_self & (pd.rij > 0)
    q = dict(u=scene.u[:, None], v=scene.v[:, None], w=scene.w[:, None],
             wx=scene.wx[:, None], wy=scene.wy[:, None],
             wz=scene.wz[:, None], rad=scene.rad_s[:, None],
             m=scene.m[:, None])
    s = dict(u=scene.u[j], v=scene.v[j], w=scene.w[j],
             wx=scene.wx[j], wy=scene.wy[j], wz=scene.wz[j],
             rad=scene.rad_s[j], m=scene.m[j])
    return lvc_force_core(q, s, pd.xij, pd.yij, pd.zij, pd.rij, cand,
                          j, scene.dem_id[j], dt, kn, mu, en,
                          tng_idx, tng_dem, tng_fx, tng_fy, tng_fz)


def lvc_force_core(q, s, xij, yij, zij, rij, cand, j, dem_j, dt,
                   kn: float, mu: float, en: float,
                   tng_idx, tng_dem, tng_fx, tng_fy, tng_fz):
    """LVCForce pair physics on explicit [R, K] candidate arrays —
    shared by the [N, K] list engine (:func:`lvc_force`) and the dense
    cell engine (``dem_cell.lvc_force_cell``), mirroring the
    ``lvc_displacement_core`` split."""
    kt = 2.0 / 7.0 * kn
    log_en = jnp.log(en)
    alpha = 2.0 * jnp.sqrt(kn) * jnp.abs(log_en) / jnp.sqrt(
        jnp.pi**2 + log_en**2)

    overlap = q["rad"] + s["rad"] - rij
    gate = cand & (overlap > 0)
    rinv = 1.0 / jnp.maximum(rij, 1e-300)
    nx, ny, nz = xij * rinv, yij * rinv, zij * rinv

    a_i = q["rad"] - overlap / 2.0
    a_j = s["rad"] - overlap / 2.0
    wxi, wyi, wzi = q["wx"], q["wy"], q["wz"]
    wxj, wyj, wzj = s["wx"], s["wy"], s["wz"]
    vi_x = q["u"] + (wyi * nz - wzi * ny) * a_i
    vi_y = q["v"] + (wzi * nx - wxi * nz) * a_i
    vi_z = q["w"] + (wxi * ny - wyi * nx) * a_i
    vj_x = s["u"] + (-wyj * nz + wzj * ny) * a_j
    vj_y = s["v"] + (-wzj * nx + wxj * nz) * a_j
    vj_z = s["w"] + (-wxj * ny + wyj * nx) * a_j
    # NOTE: the reference's LVCForce (:353-381) uses vr = v_j - v_i and a
    # NEGATIVE spring term (fn = -kn*overlap*n), i.e. an attractive
    # normal force — that code is unreachable through the reference
    # scheme (duplicated elif, :729/:750) and was clearly never run.  We
    # use the same (repulsive) convention as LVCDisplacement.
    vr_x, vr_y, vr_z = vi_x - vj_x, vi_y - vj_y, vi_z - vj_z
    vdotn = vr_x * nx + vr_y * ny + vr_z * nz
    vt_x = vr_x - vdotn * nx
    vt_y = vr_y - vdotn * ny
    vt_z = vr_z - vdotn * nz

    m_eff = q["m"] * s["m"] / (q["m"] + s["m"])
    eta_n = alpha * jnp.sqrt(m_eff)
    fn = kn * overlap - eta_n * vdotn
    fn_x, fn_y, fn_z = fn * nx, fn * ny, fn * nz

    found, slot_found = _match_slots(tng_idx, tng_dem, j, dem_j)
    found &= gate
    new_mask = gate & ~found
    slot_new = _allocate_slots(tng_idx < 0, new_mask)
    rows = jnp.broadcast_to(jnp.arange(j.shape[0])[:, None], j.shape)
    sf = jnp.clip(slot_found, 0, tng_fx.shape[1] - 1)
    # effective slot this pair writes to (found slot or fresh one)
    eff = jnp.where(found, sf, jnp.where(slot_new >= 0, slot_new, -1))
    live = eff >= 0

    fx_s = jnp.where(found, tng_fx[rows, sf], 0.0) - kt * vt_x * dt
    fy_s = jnp.where(found, tng_fy[rows, sf], 0.0) - kt * vt_y * dt
    fz_s = jnp.where(found, tng_fz[rows, sf], 0.0) - kt * vt_z * dt

    # Coulomb cap (the reference's check at :485-489 compares a SQUARED
    # magnitude against an unsquared one and divides by the square —
    # we use the intended comparison)
    fn_magn = jnp.sqrt(fn_x**2 + fn_y**2 + fn_z**2)
    ft_magn = jnp.sqrt(fx_s**2 + fy_s**2 + fz_s**2)
    fn_mu = mu * fn_magn
    slip = ft_magn >= fn_mu
    inv = jnp.where(ft_magn > 0, 1.0 / jnp.maximum(ft_magn, 1e-300), 0.0)
    fx_s = jnp.where(slip, fn_mu * fx_s * inv, fx_s)
    fy_s = jnp.where(slip, fn_mu * fy_s * inv, fy_s)
    fz_s = jnp.where(slip, fn_mu * fz_s * inv, fz_s)

    def wb(tab, val):
        return tab.at[rows, jnp.where(live, eff, tab.shape[1])].set(
            jnp.where(live, val, 0.0), mode="drop")

    tng_fx = wb(tng_fx, fx_s)
    tng_fy = wb(tng_fy, fy_s)
    tng_fz = wb(tng_fz, fz_s)
    tng_idx = tng_idx.at[rows, jnp.where(slot_new >= 0, slot_new,
                                         tng_idx.shape[1])].set(
        j.astype(jnp.int32), mode="drop")
    tng_dem = tng_dem.at[rows, jnp.where(slot_new >= 0, slot_new,
                                         tng_dem.shape[1])].set(
        dem_j.astype(jnp.int32), mode="drop")

    gl = gate & live
    gsum = lambda v: jnp.sum(jnp.where(gl, v, 0.0), axis=1)
    fx = gsum(fn_x + fx_s)
    fy = gsum(fn_y + fy_s)
    fz = gsum(fn_z + fz_s)
    torx = gsum((ny * fz_s - nz * fy_s) * a_i)
    tory = gsum((nz * fx_s - nx * fz_s) * a_i)
    torz = gsum((nx * fy_s - ny * fx_s) * a_i)
    count = jnp.sum(tng_idx >= 0, axis=1).astype(jnp.int32)
    return fx, fy, fz, torx, tory, torz, tng_idx, tng_dem, tng_fx, tng_fy, tng_fz, count

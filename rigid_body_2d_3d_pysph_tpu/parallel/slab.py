"""Spatially-local multi-chip sharding: x-slab decomposition with
``shard_map`` + ``ppermute`` halo exchange.

The GSPMD row-sharding path (``parallel/sharded.py``) is correct but
communication-oblivious: neighbor gathers across shards lower to full
all-gathers — O(N) interconnect traffic per step per device.  This module is the
SURVEY §7.7 / §2.3.4 plan executed for real: devices own contiguous
x-slabs of the *cell grid*, each step exchanges only the boundary strip
(O(halo)) with its two ring neighbors, and per-body force/torque
reductions ride one small ``psum``.  There is no reference file to
match — the reference is single-node OpenMP (``automate.py:17-19``);
this is the multi-device scaling story for the particle axis.

Design:

* The cell-grid layout (origin/dims/cell size) stays GLOBAL and static;
  a device simply bins *its own* particles (+ received ghosts), so every
  device runs the identical program and no per-device grid config is
  needed.  Slab d owns cells with ``cx in [d*W, (d+1)*W)``.
* Host-side ``slab_decompose`` sorts particles by slab and pads each
  slab to a uniform per-device capacity (static shapes); ownership is
  re-established between device chunks by ``redistribute`` (classic
  MD-style re-decomposition; the in-step halo covers intra-chunk drift,
  and the step raises ``nbr_overflow`` if a particle outruns it).
* Per step, each device compacts the particles within ``halo_width`` of
  its slab faces into fixed-capacity send buffers, ``ppermute``s them to
  the ring neighbors, appends the received rows as source-only ghosts
  (``is_rigid=0`` so they never act as queries and never contribute
  force rows), and runs the standard fused cell-engine contact pipeline
  on the extended local scene.
* Per-body state is replicated; every device computes the identical
  body update from the ``psum``-reduced force/torque.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import config
from ..ops import cellpairs as cellmod
from ..state.scene import Scene

# fields a ghost (source-only) particle must carry into the pair pass
GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "h", "m", "rho",
                "contact_force_is_boundary")
_BIG = 1.0e9


@dataclass(frozen=True)
class SlabConfig:
    """Static decomposition parameters (identical on every device)."""

    base: cellmod.CellGridConfig  # global grid geometry
    n_dev: int                    # devices along the slab axis
    slab_cells: int               # owned cell columns per device
    n_cap: int                    # particle capacity per device
    halo_cap: int                 # ghost capacity per face
    nc_max_local: int             # occupied-cell bound per device

    @property
    def halo_width(self) -> float:
        # one stencil ring of cells covers cutoff + skin
        return self.base.cell * self.base.sub

    def slab_lo(self, d):
        """x of slab d's lower face (traced-friendly)."""
        return self.base.origin[0] + (self.base.sub + d * self.slab_cells
                                      ) * self.base.cell


def _slab_of(x, cfg: SlabConfig):
    """Owning slab index per particle (clipped to the mesh)."""
    cx = np.floor((np.asarray(x) - cfg.base.origin[0]) / cfg.base.cell
                  ).astype(np.int64) - cfg.base.sub
    return np.clip(cx // cfg.slab_cells, 0, cfg.n_dev - 1)


def make_slab_config(scene: Scene, base: cellmod.CellGridConfig,
                     n_dev: int, cap_safety: float = 1.35,
                     halo_safety: float = 2.0) -> SlabConfig:
    """Size the decomposition from the initial particle distribution."""
    gx = base.dims[0]
    interior = gx - 2 * base.sub
    slab_cells = -(-interior // n_dev)
    cfg = SlabConfig(base=base, n_dev=n_dev, slab_cells=int(slab_cells),
                     n_cap=0, halo_cap=0, nc_max_local=0)
    slab = _slab_of(scene.x, cfg)
    counts = np.bincount(slab, minlength=n_dev)
    n_cap = int(-(-int(counts.max() * cap_safety) // 8) * 8)
    # ghosts per face: particles within one cell ring of a face
    x = np.asarray(scene.x)
    h_max = 0
    for d in range(n_dev):
        lo = cfg.slab_lo(d)
        hi = cfg.slab_lo(d + 1)
        w = cfg.halo_width
        h_max = max(h_max,
                    int(((x >= lo) & (x < lo + w)).sum()),
                    int(((x >= hi - w) & (x < hi)).sum()))
    halo_cap = int(-(-max(8, int(h_max * halo_safety)) // 8) * 8)
    # occupied cells per slab region (+ the two halo rings)
    cells = np.floor((x - base.origin[0]) / base.cell).astype(np.int64)
    cy = np.floor((np.asarray(scene.y) - base.origin[1]) / base.cell
                  ).astype(np.int64)
    cz = (np.floor((np.asarray(scene.z) - base.origin[2]) / base.cell
                   ).astype(np.int64) if base.dim == 3
          else np.zeros_like(cells))
    nc_local = 0
    for d in range(n_dev):
        m = (slab >= max(d - 1, 0)) & (slab <= min(d + 1, n_dev - 1))
        _, cnts = np.unique(np.stack([cells[m], cy[m], cz[m]], 1),
                            axis=0, return_counts=True)
        if base.spill:  # slots, not cells (a cell takes ceil(count/M))
            occ = int((-(-cnts // base.M)).sum())
        else:
            occ = len(cnts)
        nc_local = max(nc_local, occ)
    nc_max_local = max(64, int(nc_local * 1.6))
    return SlabConfig(base=base, n_dev=n_dev, slab_cells=int(slab_cells),
                      n_cap=n_cap, halo_cap=halo_cap,
                      nc_max_local=nc_max_local)


def slab_decompose(scene: Scene, cfg: SlabConfig) -> Scene:
    """Host-side: order particles by owning slab, pad every slab to
    ``n_cap`` with inactive sentinels -> one [n_dev * n_cap] scene ready
    to shard on axis 0."""
    slab = _slab_of(scene.x, cfg)
    n = scene.n
    perm_parts, pad_rows = [], []
    for d in range(cfg.n_dev):
        idx = np.nonzero(slab == d)[0]
        if len(idx) > cfg.n_cap:
            raise RuntimeError(
                f"slab {d} holds {len(idx)} > capacity {cfg.n_cap}")
        perm_parts.append(idx)
        pad_rows.append(cfg.n_cap - len(idx))

    fields = {}
    for k, v in scene.fields.items():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == n:
            parts = []
            for d, idx in enumerate(perm_parts):
                part = arr[idx]
                if pad_rows[d]:
                    pad_shape = (pad_rows[d],) + arr.shape[1:]
                    if k in ("x", "y", "z"):
                        pad = np.full(pad_shape, _BIG, arr.dtype)
                    elif k in ("m", "rho", "h", "moi"):
                        pad = np.ones(pad_shape, arr.dtype)
                    elif k in ("gid", "tng_idx", "tng_idx_dem_id",
                               "dem_id"):
                        pad = np.full(pad_shape, -1, arr.dtype)
                    else:
                        pad = np.zeros(pad_shape, arr.dtype)
                    part = np.concatenate([part, pad])
                parts.append(part)
            fields[k] = jnp.asarray(np.concatenate(parts))
        else:
            fields[k] = v
    out = Scene(fields, scene.meta)
    return out.replace(active=out.active & (out.x < _BIG / 2))


def redistribute(scene: Scene, cfg: SlabConfig) -> Scene:
    """Host-side re-decomposition between device chunks: re-sort the
    (already slab-ordered, padded) scene by current positions."""
    keep = np.asarray(scene.active)
    idx = np.nonzero(keep)[0]
    fields = {}
    n = scene.n
    for k, v in scene.fields.items():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == n:
            fields[k] = arr[idx]
        else:
            fields[k] = v
    packed = Scene({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in fields.items()}, scene.meta)
    return slab_decompose(packed, cfg)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _compact_two_faces(m_left, m_right, fields, cap, flag_at=None):
    """Both faces' send buffers from ONE stable 3-way sort (key 0 =
    left-band row, 1 = right-band, 2 = rest): the sorted prefix is the
    left buffer, the following run the right one.  Requires the bands
    DISJOINT (slabs >= 2 cells wide).  Bit-identical buffers to two
    :func:`_compact_rows` calls — stable sort preserves in-band order."""
    n = m_left.shape[0]
    key = jnp.where(m_left, 0, jnp.where(m_right, 1, 2)).astype(jnp.int32)
    order = jnp.argsort(key, stable=True)
    nl = jnp.sum(m_left.astype(jnp.int32))
    nr = jnp.sum(m_right.astype(jnp.int32))
    idx = jnp.arange(cap, dtype=jnp.int32)
    take_l = order[:cap]
    take_r = order.at[jnp.minimum(nl + idx, n - 1)].get(mode="clip")

    def build(take, valid):
        cols = [jnp.where(valid, f[take], 0.0) for f in fields]
        cols.insert(len(cols) if flag_at is None else flag_at,
                    valid.astype(fields[0].dtype))
        return jnp.stack(cols, axis=1)

    return (build(take_l, idx < nl), build(take_r, idx < nr),
            jnp.sum(m_left) > cap, jnp.sum(m_right) > cap)


def _compact_rows(mask, fields, cap, flag_at=None):
    """First ``cap`` rows matching ``mask`` (stable order), as a
    [cap, F+1] buffer with a validity-flag column (inserted at
    ``flag_at``; appended last by default)."""
    n = mask.shape[0]
    order = jnp.argsort(jnp.where(mask, 0, 1), stable=True)
    take = order[:cap]
    valid = mask[take]
    cols = [jnp.where(valid, f[take], 0.0) for f in fields]
    cols.insert(len(cols) if flag_at is None else flag_at,
                valid.astype(fields[0].dtype))
    overflow = jnp.sum(mask) > cap
    return jnp.stack(cols, axis=1), overflow


def _require_cell_engine(scheme) -> None:
    """The slab steps are built on the cell grid: a scheme set to
    another engine is refused, not silently run on this one."""
    if scheme.engine != "cell":
        raise ValueError(f"the slab path runs the cell engine; the scheme "
                         f"is set to {scheme.engine!r}")


def make_slab_step(scheme, scene: Scene, mesh: Mesh, cfg: SlabConfig,
                   chain: int = 1):
    """Build the sharded fused step: per-device halo exchange + local
    cell-engine contact evaluation + psum body reduction.

    ``scene`` must already be slab-decomposed (:func:`slab_decompose`)
    and sharded (:func:`shard_slab_scene`).  ``chain`` > 1 runs that
    many steps per call via ``lax.scan`` INSIDE the shard_map — one
    dispatch per chain instead of per step.
    """
    from ..models import rigid_body as rb
    from ..ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    params = dict(kr=scheme.kr, kf=scheme.kf,
                  fric_coeff=scheme.fric_coeff,
                  gx=scheme.gx, gy=scheme.gy, gz=scheme.gz)
    two_d = scheme.two_d
    _require_cell_engine(scheme)
    base = cfg.base
    # chunk == NC_max so map_over_cells runs the single-block path (a
    # bigger global chunk would pad every device's small local grid up
    # to it, multiplying the per-device pair work)
    local_chunk = min(base.cell_chunk, -(-cfg.nc_max_local // 8) * 8)
    local_cfg = dataclasses.replace(
        base, NC_max=cfg.nc_max_local, cell_chunk=local_chunk, skin=0.0)
    H = cfg.halo_cap
    D = cfg.n_dev
    fdt = config.float_dtype()

    specs = {}
    nrows = scene.n
    for k, v in scene.fields.items():
        if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == nrows:
            specs[k] = P("p", *([None] * (v.ndim - 1)))
        else:
            specs[k] = P()
    keys = sorted(scene.fields.keys())
    scene_spec = Scene({k: specs[k] for k in keys}, scene.meta)

    def local_step(scene_l: Scene, dt):
        d = jax.lax.axis_index("p")
        lo = cfg.slab_lo(d)
        hi = cfg.slab_lo(d + 1)
        w = cfg.halo_width

        scene_l = rb._body_half_kick(scene_l, dt, two_d)
        scene_l = rb._particles_from_body_velocity(scene_l)

        # ---- halo exchange ------------------------------------------------
        act = scene_l.active
        # ONE compaction sort for BOTH faces (dem/fluid ride the same
        # buffer; the valid flag stays at column len(GHOST_FIELDS)):
        # key left-face rows 0, right-face 1, rest 2 — a stable sort
        # puts the left band first, then the right band, and each
        # face's buffer is a slice.  Face membership is exclusive for
        # slabs >= 2 cells wide (each band is one cell ring); a
        # particle in both bands only occurs on degenerate 1-cell
        # slabs, where it must go to BOTH faces — fall back to two
        # sorts there.  Stable order within each band matches the
        # two-sort form exactly, so buffers are bit-identical.
        gf = ([scene_l[k] for k in GHOST_FIELDS]
              + [scene_l.dem_id.astype(fdt),
                 scene_l.is_fluid.astype(fdt)])
        m_left = act & (scene_l.x < lo + w)
        m_right = act & (scene_l.x >= hi - w)
        if cfg.slab_cells >= 2:
            left_buf, right_buf, ovl, ovr = _compact_two_faces(
                m_left, m_right, gf, H, flag_at=len(GHOST_FIELDS))
        else:
            right_buf, ovr = _compact_rows(m_right, gf, H,
                                           flag_at=len(GHOST_FIELDS))
            left_buf, ovl = _compact_rows(m_left, gf, H,
                                          flag_at=len(GHOST_FIELDS))

        # ring sends (non-periodic: edge devices receive zeros -> valid=0)
        from_left = jax.lax.ppermute(
            right_buf, "p", [(i, i + 1) for i in range(D - 1)])
        from_right = jax.lax.ppermute(
            left_buf, "p", [(i + 1, i) for i in range(D - 1)])
        ghosts = jnp.concatenate([from_left, from_right], axis=0)  # [2H, F]
        gvalid = ghosts[:, len(GHOST_FIELDS)] > 0.5

        # ---- extended local scene (ghosts are source-only) ----------------
        nl = scene_l.n
        S = scene_l.meta.total_no_bodies
        ext = {}
        gcol = {k: ghosts[:, i] for i, k in enumerate(GHOST_FIELDS)}
        gdem = ghosts[:, len(GHOST_FIELDS) + 1].astype(jnp.int32)
        gfluid = ghosts[:, len(GHOST_FIELDS) + 2] > 0.5
        for k, v in scene_l.fields.items():
            if not (hasattr(v, "ndim") and v.ndim >= 1
                    and v.shape[0] == nl):
                ext[k] = v
                continue
            if k in gcol:
                tail = gcol[k].astype(v.dtype)
                if k in ("x", "y", "z"):
                    tail = jnp.where(gvalid, tail, _BIG)
            elif k == "dem_id":
                tail = jnp.where(gvalid, gdem, -1)
            elif k == "is_fluid":
                tail = gvalid & gfluid
            elif k == "active":
                tail = gvalid
            else:
                # incl. is_rigid=0: ghosts never act as queries
                tail = jnp.zeros((2 * H,) + v.shape[1:], v.dtype)
            ext[k] = jnp.concatenate([v, tail], axis=0)
        scene_e = Scene(ext, scene_l.meta)

        # ---- local grid + fused contact pipeline --------------------------
        grid = cellmod.build_cell_grid(scene_e.x, scene_e.y, scene_e.z,
                                       scene_e.active, local_cfg)
        scene_e = rb.rigid_contact_force_eval_cell(
            scene_e, grid, local_cfg, kernel, params, dt)
        govf = grid.overflow

        # psum the per-body reduction (ghosts contributed nothing)
        force = jax.lax.psum(scene_e.force, "p")
        torque = jax.lax.psum(scene_e.torque, "p")

        # drop ghost rows, keep the new slot state
        upd = {k: (v[:nl] if hasattr(v, "ndim") and v.ndim >= 1
                   and v.shape[0] == nl + 2 * H else v)
               for k, v in scene_e.fields.items()}
        scene_l = Scene(upd, scene_l.meta)
        scene_l = scene_l.replace(
            force=force, torque=torque,
            nbr_overflow=(scene_l.nbr_overflow | govf | ovr | ovl))

        scene_l = rb._body_drift(scene_l, dt, two_d)
        scene_l = rb._particles_from_body_position(scene_l)
        scene_l = rb._body_half_kick(scene_l, dt, two_d)
        scene_l = rb._particles_from_body_velocity(scene_l)
        return scene_l

    if chain > 1:
        def local_multi(scene_l: Scene, dt):
            def body(s, _):
                return local_step(s, dt), None
            out, _ = jax.lax.scan(body, scene_l, None, length=chain)
            return out
        fn = local_multi
    else:
        fn = local_step
    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(scene_spec, P()),
        out_specs=scene_spec, check_vma=False))
    return step


def make_slab_redistribute(scene: Scene, mesh: Mesh, cfg: SlabConfig):
    """Jitted ON-DEVICE re-decomposition: each device compacts its
    emigrant rows (current slab != own slab), ``ppermute``s them to the
    adjacent ring neighbor, and packs arrivals into its inactive tail.

    Replaces the host-side :func:`redistribute` round-trip between
    device chunks — with this, multi-chunk sharded runs never leave the
    devices.  Emigration is bounded like the halo: at most
    ``cfg.halo_cap`` rows per face per call, and at most ONE slab of
    travel per call (a row two slabs away is forwarded again by the
    next call, but its pair interactions are wrong until it arrives, so
    ``nbr_overflow`` is raised — call redistribute at least as often as
    the halo-validity bound allows drift).

    All per-particle state travels, including [N, L] contact-table
    rows (the tables are gid-keyed, so slot renumbering is free).
    int/bool fields ride the float buffer — exact for gids < 2^24 in
    f32.
    """
    D = cfg.n_dev
    E = cfg.halo_cap
    fdt = config.float_dtype()
    nrows = scene.n
    nl = nrows // D

    # flattened travel layout: every [N, ...] field as f32 columns
    keys = sorted(k for k, v in scene.fields.items()
                  if hasattr(v, "ndim") and v.ndim >= 1
                  and v.shape[0] == nrows)
    col_of = {}
    ncols = 0
    for k in keys:
        w = int(np.prod(scene.fields[k].shape[1:])) if \
            scene.fields[k].ndim > 1 else 1
        col_of[k] = (ncols, w)
        ncols += w

    # inactive-row pad values (mirrors slab_decompose's padding)
    def pad_value(k):
        if k in ("x", "y", "z"):
            return _BIG
        if k in ("m", "rho", "h", "moi"):
            return 1.0
        if k in ("gid", "tng_idx", "tng_idx_dem_id", "dem_id"):
            return -1.0
        return 0.0

    scene_spec = _scene_spec(scene)

    def flatten(scene_l):
        cols = []
        for k in keys:
            v = scene_l.fields[k].astype(fdt)
            cols.append(v.reshape(v.shape[0], -1) if v.ndim > 1
                        else v[:, None])
        return jnp.concatenate(cols, axis=1)  # [nl, ncols]

    def unflatten(buf, scene_l):
        upd = {}
        for k in keys:
            c0, w = col_of[k]
            v0 = scene_l.fields[k]
            col = buf[:, c0:c0 + w]
            col = col.reshape((buf.shape[0],) + v0.shape[1:])
            upd[k] = col.astype(v0.dtype)
        return scene_l.replace(**upd)

    a_col = col_of["active"][0]

    def local_redis(scene_l: Scene):
        d = jax.lax.axis_index("p")
        # traced twin of _slab_of (which is numpy/host-side)
        cx = jnp.floor((scene_l.x - cfg.base.origin[0]) / cfg.base.cell
                       ).astype(jnp.int32) - cfg.base.sub
        slab = jnp.clip(cx // cfg.slab_cells, 0, cfg.n_dev - 1)
        act = scene_l.active
        stay = act & (slab == d)
        go_l = act & (slab < d)
        go_r = act & (slab > d)
        far = act & ((slab < d - 1) | (slab > d + 1))

        buf = flatten(scene_l)
        cols = [buf[:, i] for i in range(ncols)]
        bufL, ovl = _compact_rows(go_l, cols, E)   # [E, ncols+1]
        bufR, ovr = _compact_rows(go_r, cols, E)
        recv_r = jax.lax.ppermute(
            bufL, "p", [(i, i - 1) for i in range(1, D)])
        recv_l = jax.lax.ppermute(
            bufR, "p", [(i, i + 1) for i in range(D - 1)])
        arrivals = jnp.concatenate([recv_r, recv_l], axis=0)  # [2E, C+1]
        avalid = arrivals[:, -1] > 0.5

        # stayers to the front (stable), arrivals into the tail
        order = jnp.argsort(jnp.where(stay, 0, 1), stable=True)
        sbuf = buf[order]
        n_stay = jnp.sum(stay).astype(jnp.int32)
        arank = jnp.cumsum(avalid.astype(jnp.int32)) - 1
        dest = jnp.where(avalid, n_stay + arank, nl)
        row_ovf = (n_stay + jnp.sum(avalid.astype(jnp.int32))) > nl
        sbuf = sbuf.at[dest].set(arrivals[:, :ncols], mode="drop")

        n_tot = n_stay + jnp.sum(avalid.astype(jnp.int32))
        live = jnp.arange(nl, dtype=jnp.int32) < n_tot
        pads = jnp.asarray([pad_value(k) for k in keys for _ in
                            range(col_of[k][1])], fdt)
        sbuf = jnp.where(live[:, None], sbuf, pads[None, :])
        sbuf = sbuf.at[:, a_col].set(jnp.where(live, 1.0, 0.0))

        out = unflatten(sbuf, scene_l)
        ovf = (ovl | ovr | row_ovf | jnp.any(far)).astype(jnp.int32)
        ovf = jax.lax.psum(ovf, "p") > 0  # any device's overflow counts
        return out.replace(nbr_overflow=scene_l.nbr_overflow | ovf)

    return jax.jit(jax.shard_map(
        local_redis, mesh=mesh, in_specs=(scene_spec,),
        out_specs=scene_spec, check_vma=False))


def attach_gids(scene: Scene) -> Scene:
    """Persistent global particle ids (int32 row index at attach time).
    The slab DEM/coupling paths key contact tables on gids so table
    state survives ghost-row renumbering and redistribution; attach
    BEFORE :func:`slab_decompose`."""
    return scene.with_fields(gid=jnp.arange(scene.n, dtype=jnp.int32))


def _scene_spec(scene: Scene):
    specs = {}
    nrows = scene.n
    for k, v in scene.fields.items():
        if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == nrows:
            specs[k] = P("p", *([None] * (v.ndim - 1)))
        else:
            specs[k] = P()
    return Scene({k: specs[k] for k in sorted(specs)}, scene.meta)


# ghost columns for the DEM pair pass (all ride one f32 buffer)
DEM_GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz",
                    "rad_s", "m")


def make_slab_dem_step(scheme, scene: Scene, mesh: Mesh, cfg: SlabConfig,
                       n_global: int):
    """Sharded DEM step: halo exchange of grain state + gid-keyed
    contact tables evaluated locally (tables travel with their OWNING
    row; ghosts are extra source rows, so no table rows ever migrate
    mid-chunk — redistribution between chunks carries them as ordinary
    fields).  No global reduction exists in DEM (pair forces are
    query-side sums), so the only collectives are the two ring
    ppermutes.

    ``scene`` must carry ``gid`` (:func:`attach_gids`), be decomposed
    and sharded.  ``n_global`` is the total (pre-decomposition)
    particle count — the gid translation-table size."""
    from ..ops import dem as dops
    from ..ops import dem_cell as dcops

    _require_cell_engine(scheme)
    base = cfg.base
    local_chunk = min(base.cell_chunk, -(-cfg.nc_max_local // 8) * 8)
    local_cfg = dataclasses.replace(
        base, NC_max=cfg.nc_max_local, cell_chunk=local_chunk, skin=0.0)
    H = cfg.halo_cap
    D = cfg.n_dev
    fdt = config.float_dtype()
    gx_, gy_, gz_ = scheme.gx, scheme.gy, scheme.gz
    scene_spec = _scene_spec(scene)
    NGF = len(DEM_GHOST_FIELDS)

    def local_step(scene_l: Scene, dt):
        d = jax.lax.axis_index("p")
        lo = cfg.slab_lo(d)
        hi = cfg.slab_lo(d + 1)
        w = cfg.halo_width

        # stage 1: half-kick with stored forces (granular rows only)
        mob = scene_l.is_rigid
        half = 0.5 * dt
        m_inv = 1.0 / scene_l.m
        I_inv = 1.0 / scene_l.moi
        sel = lambda new, old: jnp.where(mob, new, old)
        scene_l = scene_l.replace(
            u=sel(scene_l.u + half * scene_l.fx * m_inv, scene_l.u),
            v=sel(scene_l.v + half * scene_l.fy * m_inv, scene_l.v),
            w=sel(scene_l.w + half * scene_l.fz * m_inv, scene_l.w),
            wx=sel(scene_l.wx + half * scene_l.torx * I_inv, scene_l.wx),
            wy=sel(scene_l.wy + half * scene_l.tory * I_inv, scene_l.wy),
            wz=sel(scene_l.wz + half * scene_l.torz * I_inv, scene_l.wz),
        )

        # ---- halo exchange ----------------------------------------------
        act = scene_l.active
        gf = [scene_l[k] for k in DEM_GHOST_FIELDS] + [
            scene_l.dem_id.astype(fdt), scene_l.gid.astype(fdt)]
        right_buf, ovr = _compact_rows(act & (scene_l.x >= hi - w), gf, H)
        left_buf, ovl = _compact_rows(act & (scene_l.x < lo + w), gf, H)
        from_left = jax.lax.ppermute(
            right_buf, "p", [(i, i + 1) for i in range(D - 1)])
        from_right = jax.lax.ppermute(
            left_buf, "p", [(i + 1, i) for i in range(D - 1)])
        ghosts = jnp.concatenate([from_left, from_right], axis=0)
        # validity flag rides LAST column (after the int extras)
        gvalid = ghosts[:, NGF + 2] > 0.5

        nl = scene_l.n
        ext = {}
        gcol = {k: ghosts[:, i] for i, k in enumerate(DEM_GHOST_FIELDS)}
        gdem = ghosts[:, NGF].astype(jnp.int32)
        ggid = ghosts[:, NGF + 1].astype(jnp.int32)
        for k, v in scene_l.fields.items():
            if not (hasattr(v, "ndim") and v.ndim >= 1
                    and v.shape[0] == nl):
                ext[k] = v
                continue
            if k in gcol:
                tail = gcol[k].astype(v.dtype)
                if k in ("x", "y", "z"):
                    tail = jnp.where(gvalid, tail, _BIG)
            elif k == "dem_id":
                tail = jnp.where(gvalid, gdem, -1)
            elif k == "gid":
                tail = jnp.where(gvalid, ggid, -1)
            elif k == "active":
                tail = gvalid
            elif k in ("tng_idx", "tng_idx_dem_id"):
                tail = jnp.full((2 * H,) + v.shape[1:], -1, v.dtype)
            elif k == "moi":
                tail = jnp.ones((2 * H,) + v.shape[1:], v.dtype)
            else:
                # incl. is_rigid=0: ghost force/table outputs are dropped
                tail = jnp.zeros((2 * H,) + v.shape[1:], v.dtype)
            ext[k] = jnp.concatenate([v, tail], axis=0)
        scene_e = Scene(ext, scene_l.meta)

        # ---- contact evaluation on the extended scene -------------------
        grid = cellmod.build_cell_grid(scene_e.x, scene_e.y, scene_e.z,
                                       scene_e.active, local_cfg)
        # gid -> extended-row translation for the prune
        ne = scene_e.n
        row_of_gid = jnp.full(n_global + 1, ne, jnp.int32).at[
            jnp.where(scene_e.active & (scene_e.gid >= 0),
                      scene_e.gid, n_global)
        ].set(jnp.arange(ne, dtype=jnp.int32), mode="drop")
        tabs = dops.prune_contact_table(
            scene_e, scene_e.tng_idx, scene_e.tng_idx_dem_id,
            scene_e.tng_x, scene_e.tng_y, scene_e.tng_z,
            row_of_gid=row_of_gid)[:5]
        (cfx, cfy, cfz, tx_, ty_, tz_, ti, td, ta, tb, tc,
         cnt) = dcops.lvc_displacement_cell(
             scene_e, grid, local_cfg, dt, *tabs)

        gmask = scene_e.is_rigid & scene_e.active
        scene_e = scene_e.replace(
            fx=jnp.where(gmask, scene_e.m * gx_ + cfx, 0.0),
            fy=jnp.where(gmask, scene_e.m * gy_ + cfy, 0.0),
            fz=jnp.where(gmask, scene_e.m * gz_ + cfz, 0.0),
            torx=jnp.where(gmask, tx_, 0.0),
            tory=jnp.where(gmask, ty_, 0.0),
            torz=jnp.where(gmask, tz_, 0.0),
            tng_idx=ti, tng_idx_dem_id=td,
            tng_x=ta, tng_y=tb, tng_z=tc, total_tng_contacts=cnt,
        )

        # drop ghosts, fold overflow
        upd = {k: (v[:nl] if hasattr(v, "ndim") and v.ndim >= 1
                   and v.shape[0] == nl + 2 * H else v)
               for k, v in scene_e.fields.items()}
        scene_l = Scene(upd, scene_l.meta)
        scene_l = scene_l.replace(
            nbr_overflow=(scene_l.nbr_overflow | grid.overflow
                          | ovr | ovl))

        # stage 2 drift + stage 3 half-kick
        sel = lambda new, old: jnp.where(mob, new, old)
        scene_l = scene_l.replace(
            x=sel(scene_l.x + dt * scene_l.u, scene_l.x),
            y=sel(scene_l.y + dt * scene_l.v, scene_l.y),
            z=sel(scene_l.z + dt * scene_l.w, scene_l.z),
        )
        m_inv = 1.0 / scene_l.m
        I_inv = 1.0 / scene_l.moi
        scene_l = scene_l.replace(
            u=sel(scene_l.u + half * scene_l.fx * m_inv, scene_l.u),
            v=sel(scene_l.v + half * scene_l.fy * m_inv, scene_l.v),
            w=sel(scene_l.w + half * scene_l.fz * m_inv, scene_l.w),
            wx=sel(scene_l.wx + half * scene_l.torx * I_inv, scene_l.wx),
            wy=sel(scene_l.wy + half * scene_l.tory * I_inv, scene_l.wy),
            wz=sel(scene_l.wz + half * scene_l.torz * I_inv, scene_l.wz),
        )
        return scene_l

    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh, in_specs=(scene_spec, P()),
        out_specs=scene_spec, check_vma=False))
    return step


# ghost columns for the coupling pair passes (fluid + wall-BC + FSI +
# rigid contact all read from this one buffer)
CPL_GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "h", "m", "rho", "p",
                    "m_fsi", "rho_fsi", "p_fsi",
                    "contact_force_is_boundary")


def make_slab_coupling_step(scheme, scene: Scene, mesh: Mesh,
                            cfg: SlabConfig):
    """Sharded rigid-fluid coupling step (KDK ordering, the scheme
    default): TWO halo exchanges per step (rates at x_n after the kick;
    wall-BC + forces at x_{n+1} after the drift) plus a column resend of
    the post-wall-BC pressures for solid ghosts, all ring ppermutes;
    per-body force/torque reductions ride one psum.  Rigid contact-slot
    state ([N, S], keyed by source ENTITY) and fluid fields own their
    rows, so nothing migrates mid-chunk.

    Runs the cell engine, like the single-device ``_make_step_cell``."""
    from ..models import rigid_body as rb
    from ..ops import fluid as fops
    from ..ops import fluid_cell as fcops
    from ..ops.cellpairs import pack_fields
    from ..ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    params = dict(kr=scheme.kr, kf=scheme.kf,
                  fric_coeff=scheme.fric_coeff,
                  gx=scheme.gx, gy=scheme.gy, gz=scheme.gz)
    gx_, gy_, gz_ = scheme.gx, scheme.gy, scheme.gz
    edac = scheme.edac
    nu_edac = scheme.edac_nu
    c0, rho0, gamma = scheme.c0, scheme.rho0, scheme.gamma
    fluid_alpha = scheme.fluid_alpha
    has_fluid = len(scheme.fluids) > 0
    has_rigid = len(scheme.rigid_bodies) > 0
    _require_cell_engine(scheme)
    if scheme.gtvf_ordering not in ("kdk", "kdkf"):
        raise NotImplementedError(
            "slab coupling step implements the kdk and kdkf stagings "
            f"(got {scheme.gtvf_ordering!r})")
    kdkf = scheme.gtvf_ordering == "kdkf"

    base = cfg.base
    local_chunk = min(base.cell_chunk, -(-cfg.nc_max_local // 8) * 8)
    local_cfg = dataclasses.replace(
        base, NC_max=cfg.nc_max_local, cell_chunk=local_chunk, skin=0.0)
    H = cfg.halo_cap
    D = cfg.n_dev
    fdt = config.float_dtype()
    scene_spec = _scene_spec(scene)
    NGF = len(CPL_GHOST_FIELDS)

    def ring(buf):
        fl = jax.lax.ppermute(buf[0], "p",
                              [(i, i + 1) for i in range(D - 1)])
        fr = jax.lax.ppermute(buf[1], "p",
                              [(i + 1, i) for i in range(D - 1)])
        return fl, fr

    def exchange(scene_l, masks):
        """Full ghost exchange -> extended scene + overflow flag."""
        mr, ml = masks
        gf = [scene_l[k] for k in CPL_GHOST_FIELDS] + [
            scene_l.dem_id.astype(fdt),
            scene_l.is_fluid.astype(fdt),
            scene_l.is_static_boundary.astype(fdt),
            scene_l.is_rigid.astype(fdt)]
        right_buf, ovr = _compact_rows(mr, gf, H)
        left_buf, ovl = _compact_rows(ml, gf, H)
        from_left, from_right = ring((right_buf, left_buf))
        ghosts = jnp.concatenate([from_left, from_right], axis=0)
        gvalid = ghosts[:, NGF + 4] > 0.5

        nl = scene_l.n
        ext = {}
        gcol = {k: ghosts[:, i] for i, k in enumerate(CPL_GHOST_FIELDS)}
        gdem = ghosts[:, NGF].astype(jnp.int32)
        gfluid = ghosts[:, NGF + 1] > 0.5
        gbdry = ghosts[:, NGF + 2] > 0.5
        grigid_src = ghosts[:, NGF + 3] > 0.5
        for k, v in scene_l.fields.items():
            if not (hasattr(v, "ndim") and v.ndim >= 1
                    and v.shape[0] == nl):
                ext[k] = v
                continue
            if k in gcol:
                tail = gcol[k].astype(v.dtype)
                if k in ("x", "y", "z"):
                    tail = jnp.where(gvalid, tail, _BIG)
                elif k in ("rho", "rho_fsi", "m", "h"):
                    tail = jnp.where(gvalid, tail, 1.0)
            elif k == "dem_id":
                tail = jnp.where(gvalid, gdem, -1)
            elif k == "is_fluid":
                tail = gvalid & gfluid
            elif k == "is_static_boundary":
                tail = gvalid & gbdry
            elif k == "active":
                tail = gvalid
            else:
                # is_rigid=0: ghosts are source-only for contact AND for
                # the fluid passes' dest gates; the rigid-source flag
                # needed by the FSI terms rides is_rigid_src below
                tail = jnp.zeros((2 * H,) + v.shape[1:], v.dtype)
            ext[k] = jnp.concatenate([v, tail], axis=0)
        scene_e = Scene(ext, scene_l.meta)
        return scene_e, grigid_src & gvalid, ovr | ovl

    # slot fields the contact eval updates (shared by both stagings'
    # local steps — a single list so a new field cannot be dropped from
    # one staging only)
    CONTACT_KEEP = (
        "fx", "fy", "fz", "delta_lt_x", "delta_lt_y", "delta_lt_z",
        "fn_x", "fn_y", "fn_z", "contact_force_normal_x",
        "contact_force_normal_y", "contact_force_normal_z",
        "contact_force_normal_wij", "contact_force_dist",
        "closest_point_dist_to_source", "x_source", "y_source",
        "z_source", "vx_source", "vy_source", "vz_source")

    def contact_and_reduce(scene_l, scene_e, grid, dt, extra, nl):
        """Contact pipeline on the extended scene (ghost sources carry
        cfib/dem; is_rigid=0 keeps them source-only) + the per-body
        force/torque psum + local-row writeback."""
        if extra is not None:
            extra = tuple(jnp.concatenate([e, jnp.zeros(2 * H, fdt)])
                          for e in extra)
        scene_c = rb.rigid_contact_force_eval_cell(
            scene_e, grid, local_cfg, kernel, params, dt, extra_fx=extra)
        upd = {k: v[:nl] for k, v in scene_c.fields.items()
               if k in CONTACT_KEEP and hasattr(v, "ndim")
               and v.ndim >= 1 and v.shape[0] == nl + 2 * H}
        return scene_l.replace(
            force=jax.lax.psum(scene_c.force, "p"),
            torque=jax.lax.psum(scene_c.torque, "p"), **upd)

    def local_step_kdkf(scene_l: Scene, dt):
        """Fused one-grid staging (the single-chip default): drift
        first, ONE ghost exchange + grid at x_{n+1}, rates AND wall
        sums on the pre-update rho/p, then a (p, p_fsi, rho) ghost
        resend before the forces/contact passes — one exchange and one
        grid build fewer per step than the kdk staging below.  Physics
        matches ``RigidFluidCouplingScheme._make_step_cell_kdkf``
        (tests/test_slab_coupling.py compares 10-step trajectories)."""
        d = jax.lax.axis_index("p")
        lo = cfg.slab_lo(d)
        hi = cfg.slab_lo(d + 1)
        w = cfg.halo_width

        fl = scene_l.is_fluid & scene_l.active
        bd = scene_l.is_static_boundary & scene_l.active
        rbm = scene_l.is_rigid & scene_l.active
        solid = bd | rbm
        ovf = scene_l.nbr_overflow

        # ---- kick ----
        if has_fluid:
            scene_l = scene_l.replace(
                u=jnp.where(fl, scene_l.u + 0.5 * dt * scene_l.au,
                            scene_l.u),
                v=jnp.where(fl, scene_l.v + 0.5 * dt * scene_l.av,
                            scene_l.v),
                w=jnp.where(fl, scene_l.w + 0.5 * dt * scene_l.aw,
                            scene_l.w),
            )
        if has_rigid:
            scene_l = rb._body_half_kick(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_velocity(scene_l)

        # ---- drift positions (thermo rides the passes below) ----
        if has_fluid:
            scene_l = scene_l.replace(
                x=jnp.where(fl, scene_l.x + dt * scene_l.u, scene_l.x),
                y=jnp.where(fl, scene_l.y + dt * scene_l.v, scene_l.y),
                z=jnp.where(fl, scene_l.z + dt * scene_l.w, scene_l.z),
            )
        if has_rigid:
            scene_l = rb._body_drift(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_position(scene_l)

        # ---- ONE exchange + grid at x_{n+1} ----
        act = scene_l.active
        masks = (act & (scene_l.x >= hi - w), act & (scene_l.x < lo + w))
        scene_e, grigid_src, ov = exchange(scene_l, masks)
        ovf = ovf | ov
        grid = cellmod.build_cell_grid(scene_e.x, scene_e.y, scene_e.z,
                                       scene_e.active, local_cfg)
        ovf = ovf | grid.overflow
        nl = scene_l.n
        src_e = scene_e.replace(
            is_rigid=scene_e.is_rigid.at[nl:].set(grigid_src))

        ffx = ffy = ffz = None
        if has_fluid:
            # ---- rates + wall sums, one pack, pre-update rho/p ----
            df, di = fcops.pack_fluid_scene(src_e, grid, local_cfg)
            arho, ap = fcops.fluid_rates_cell(
                src_e, grid, local_cfg, kernel, df, di, nu_edac, c0, edac,
                has_rigid)
            uf, vf, wfo, sw, p_num = fcops.wall_bc_cell(
                src_e, grid, local_cfg, kernel, df, di, gx_, gy_, gz_)
            arho = jnp.where(fl, arho[:nl], 0.0)
            ap = jnp.where(fl, ap[:nl], 0.0)
            rho_new = scene_l.rho + dt * arho
            upd = dict(
                arho=arho, ap=ap,
                rho=jnp.where(fl, rho_new, scene_l.rho),
                vol=jnp.where(fl, scene_l.m / rho_new, scene_l.vol),
            )
            if edac:
                upd["p"] = jnp.where(fl, scene_l.p + dt * ap, scene_l.p)
            else:
                p_t, cs_t = fops.tait_eos(
                    scene_l.replace(rho=upd["rho"]), rho0, c0, gamma, fl)
                upd["p"], upd["cs"] = p_t, cs_t
            scene_l = scene_l.replace(**upd)

            uf, vf, wfo = uf[:nl], vf[:nl], wfo[:nl]
            sw, p_num = sw[:nl], p_num[:nl]
            has = sw > 1e-14
            p_bc = jnp.where(has, p_num / jnp.where(has, sw, 1.0), p_num)
            inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
            ufn, vfn, wfn = uf * inv, vf * inv, wfo * inv
            scene_l = scene_l.replace(
                p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene_l.p),
                p_fsi=jnp.where(rbm, p_bc, scene_l.p_fsi),
                uf=jnp.where(solid, ufn, scene_l.uf),
                vf=jnp.where(solid, vfn, scene_l.vf),
                wf=jnp.where(solid, wfn, scene_l.wf),
                ug=jnp.where(solid, 2.0 * scene_l.u - ufn, scene_l.ug),
                vg=jnp.where(solid, 2.0 * scene_l.v - vfn, scene_l.vg),
                wg=jnp.where(solid, 2.0 * scene_l.w - wfn, scene_l.wg),
                wij_adami=jnp.where(solid, sw, scene_l.wij_adami),
            )

            # ---- resend updated (p, p_fsi, rho) for the ghosts ----
            cols = [scene_l.p, scene_l.p_fsi, scene_l.rho]
            pr, _ = _compact_rows(masks[0], cols, H)
            plf, _ = _compact_rows(masks[1], cols, H)
            g_l, g_r = ring((pr, plf))
            pcols = jnp.concatenate([g_l, g_r], axis=0)  # [2H, 4]
            pvalid = pcols[:, 3] > 0.5
            newp = jnp.where(pvalid, pcols[:, 0], scene_e.p[nl:])
            newpfsi = jnp.where(pvalid, pcols[:, 1], scene_e.p_fsi[nl:])
            newrho = jnp.where(pvalid, pcols[:, 2], scene_e.rho[nl:])
            scene_e = scene_e.replace(
                p=jnp.concatenate([scene_l.p, newp.astype(fdt)]),
                p_fsi=jnp.concatenate([scene_l.p_fsi,
                                       newpfsi.astype(fdt)]),
                rho=jnp.concatenate([scene_l.rho, newrho.astype(fdt)]))
            src_e = scene_e.replace(
                is_rigid=scene_e.is_rigid.at[nl:].set(grigid_src))

            # ---- forces at the patched pressures/densities ----
            df, di = fcops.pack_fluid_scene(src_e, grid, local_cfg)
            p_d = pack_fields(grid, local_cfg, [src_e.p], [0.0])[..., 0]
            pfsi_d = pack_fields(grid, local_cfg, [src_e.p_fsi],
                                 [0.0])[..., 0]
            aux, auy, auz, fxv, fyv, fzv = fcops.fluid_forces_cell(
                src_e, grid, local_cfg, kernel, df, di, p_d, pfsi_d,
                fluid_alpha, c0, has_rigid)
            scene_l = scene_l.replace(
                au=jnp.where(fl, gx_ + aux[:nl], 0.0),
                av=jnp.where(fl, gy_ + auy[:nl], 0.0),
                aw=jnp.where(fl, gz_ + auz[:nl], 0.0),
            )
            ffx = jnp.where(rbm, fxv[:nl], 0.0)
            ffy = jnp.where(rbm, fyv[:nl], 0.0)
            ffz = jnp.where(rbm, fzv[:nl], 0.0)
        if has_rigid:
            # scene_e already carries the updated local rho/p and the
            # patched ghost columns
            scene_l = contact_and_reduce(
                scene_l, scene_e, grid, dt,
                (ffx, ffy, ffz) if has_fluid else None, nl)
        scene_l = scene_l.replace(nbr_overflow=ovf)

        # ---- second half-kick ----
        if has_fluid:
            scene_l = scene_l.replace(
                u=jnp.where(fl, scene_l.u + 0.5 * dt * scene_l.au,
                            scene_l.u),
                v=jnp.where(fl, scene_l.v + 0.5 * dt * scene_l.av,
                            scene_l.v),
                w=jnp.where(fl, scene_l.w + 0.5 * dt * scene_l.aw,
                            scene_l.w),
            )
        if has_rigid:
            scene_l = rb._body_half_kick(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_velocity(scene_l)
        return scene_l

    def local_step(scene_l: Scene, dt):
        d = jax.lax.axis_index("p")
        lo = cfg.slab_lo(d)
        hi = cfg.slab_lo(d + 1)
        w = cfg.halo_width

        fl = scene_l.is_fluid & scene_l.active
        bd = scene_l.is_static_boundary & scene_l.active
        rbm = scene_l.is_rigid & scene_l.active
        solid = bd | rbm
        ovf = scene_l.nbr_overflow

        # ---- kick (half, stored accelerations/forces) ----
        if has_fluid:
            scene_l = scene_l.replace(
                u=jnp.where(fl, scene_l.u + 0.5 * dt * scene_l.au,
                            scene_l.u),
                v=jnp.where(fl, scene_l.v + 0.5 * dt * scene_l.av,
                            scene_l.v),
                w=jnp.where(fl, scene_l.w + 0.5 * dt * scene_l.aw,
                            scene_l.w),
            )
        if has_rigid:
            scene_l = rb._body_half_kick(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_velocity(scene_l)

        # ---- density/pressure rates at u_{n+1/2}, x_n ----
        if has_fluid:
            act = scene_l.active
            masks = (act & (scene_l.x >= hi - w), act & (scene_l.x < lo + w))
            scene_e, grigid_src, ov = exchange(scene_l, masks)
            ovf = ovf | ov
            grid = cellmod.build_cell_grid(scene_e.x, scene_e.y,
                                           scene_e.z, scene_e.active,
                                           local_cfg)
            ovf = ovf | grid.overflow
            # ghost rigid SOURCES must pass the src_rigid gates of the
            # fluid passes; local rows keep the real flag (ghost rows
            # still never act as fluid/rigid DESTS: active ghosts have
            # is_fluid from their owner but their outputs are dropped,
            # and wall-BC/FSI dest gates read the query flags we set)
            nl = scene_l.n
            scene_r = scene_e.replace(
                is_rigid=scene_e.is_rigid.at[nl:].set(grigid_src))
            df, di = fcops.pack_fluid_scene(scene_r, grid, local_cfg)
            arho, ap = fcops.fluid_rates_cell(
                scene_r, grid, local_cfg, kernel, df, di, nu_edac, c0,
                edac, has_rigid)
            scene_l = scene_l.replace(
                arho=jnp.where(fl, arho[:nl], 0.0),
                ap=jnp.where(fl, ap[:nl], 0.0))

        # ---- drift + thermodynamic update ----
        if has_fluid:
            rho_new = scene_l.rho + dt * scene_l.arho
            upd = dict(
                x=jnp.where(fl, scene_l.x + dt * scene_l.u, scene_l.x),
                y=jnp.where(fl, scene_l.y + dt * scene_l.v, scene_l.y),
                z=jnp.where(fl, scene_l.z + dt * scene_l.w, scene_l.z),
                rho=jnp.where(fl, rho_new, scene_l.rho),
                vol=jnp.where(fl, scene_l.m / rho_new, scene_l.vol),
            )
            if edac:
                upd["p"] = jnp.where(fl, scene_l.p + dt * scene_l.ap,
                                     scene_l.p)
            scene_l = scene_l.replace(**upd)
        if has_rigid:
            scene_l = rb._body_drift(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_position(scene_l)

        # ---- forces at (x_{n+1}, p_{n+1}, u_{n+1/2}) ----
        if has_fluid and not edac:
            p, cs = fops.tait_eos(scene_l, rho0, c0, gamma, fl)
            scene_l = scene_l.replace(p=p, cs=cs)
        act = scene_l.active
        masks = (act & (scene_l.x >= hi - w), act & (scene_l.x < lo + w))
        scene_e, grigid_src, ov = exchange(scene_l, masks)
        ovf = ovf | ov
        grid = cellmod.build_cell_grid(scene_e.x, scene_e.y, scene_e.z,
                                       scene_e.active, local_cfg)
        ovf = ovf | grid.overflow
        nl = scene_l.n
        ffx = ffy = ffz = None
        if has_fluid:
            # wall-BC Shepard sums: dest solid LOCAL rows, src fluid
            # (ghost fluids included as sources)
            src_e = scene_e.replace(
                is_rigid=scene_e.is_rigid.at[nl:].set(grigid_src))
            df, di = fcops.pack_fluid_scene(src_e, grid, local_cfg)
            uf, vf, wf, sw, p_num = fcops.wall_bc_cell(
                src_e, grid, local_cfg, kernel, df, di, gx_, gy_, gz_)
            uf, vf, wf = uf[:nl], vf[:nl], wf[:nl]
            sw, p_num = sw[:nl], p_num[:nl]
            has = sw > 1e-14
            p_bc = jnp.where(has, p_num / jnp.where(has, sw, 1.0), p_num)
            inv = jnp.where(has, 1.0 / jnp.maximum(sw, 1e-300), 0.0)
            ufn, vfn, wfn = uf * inv, vf * inv, wf * inv
            scene_l = scene_l.replace(
                p=jnp.where(bd, jnp.maximum(p_bc, 0.0), scene_l.p),
                p_fsi=jnp.where(rbm, p_bc, scene_l.p_fsi),
                uf=jnp.where(solid, ufn, scene_l.uf),
                vf=jnp.where(solid, vfn, scene_l.vf),
                wf=jnp.where(solid, wfn, scene_l.wf),
                ug=jnp.where(solid, 2.0 * scene_l.u - ufn, scene_l.ug),
                vg=jnp.where(solid, 2.0 * scene_l.v - vfn, scene_l.vg),
                wg=jnp.where(solid, 2.0 * scene_l.w - wfn, scene_l.wg),
                wij_adami=jnp.where(solid, sw, scene_l.wij_adami),
            )
            # resend the UPDATED p / p_fsi for the same ghost rows and
            # patch the extended scene (the forces pass reads wall
            # pressures through sources)
            pr, _ = _compact_rows(masks[0], [scene_l.p, scene_l.p_fsi], H)
            plf, _ = _compact_rows(masks[1], [scene_l.p, scene_l.p_fsi], H)
            g_l, g_r = ring((pr, plf))
            pcols = jnp.concatenate([g_l, g_r], axis=0)  # [2H, 3]
            pvalid = pcols[:, 2] > 0.5
            newp = jnp.where(pvalid, pcols[:, 0], scene_e.p[nl:])
            newpfsi = jnp.where(pvalid, pcols[:, 1], scene_e.p_fsi[nl:])
            scene_e = scene_e.replace(
                p=jnp.concatenate([scene_l.p, newp.astype(fdt)]),
                p_fsi=jnp.concatenate([scene_l.p_fsi,
                                       newpfsi.astype(fdt)]))
            src_e = scene_e.replace(
                is_rigid=scene_e.is_rigid.at[nl:].set(grigid_src))
            df, di = fcops.pack_fluid_scene(src_e, grid, local_cfg)
            p_d = pack_fields(grid, local_cfg, [src_e.p], [0.0])[..., 0]
            pfsi_d = pack_fields(grid, local_cfg, [src_e.p_fsi],
                                 [0.0])[..., 0]
            aux, auy, auz, fxv, fyv, fzv = fcops.fluid_forces_cell(
                src_e, grid, local_cfg, kernel, df, di, p_d, pfsi_d,
                fluid_alpha, c0, has_rigid)
            scene_l = scene_l.replace(
                au=jnp.where(fl, gx_ + aux[:nl], 0.0),
                av=jnp.where(fl, gy_ + auy[:nl], 0.0),
                aw=jnp.where(fl, gz_ + auz[:nl], 0.0),
            )
            ffx = jnp.where(rbm, fxv[:nl], 0.0)
            ffy = jnp.where(rbm, fyv[:nl], 0.0)
            ffz = jnp.where(rbm, fzv[:nl], 0.0)
        if has_rigid:
            scene_l = contact_and_reduce(
                scene_l, scene_e, grid, dt,
                (ffx, ffy, ffz) if has_fluid else None, nl)
        scene_l = scene_l.replace(nbr_overflow=ovf)

        # ---- second half-kick with fresh accelerations ----
        if has_fluid:
            scene_l = scene_l.replace(
                u=jnp.where(fl, scene_l.u + 0.5 * dt * scene_l.au,
                            scene_l.u),
                v=jnp.where(fl, scene_l.v + 0.5 * dt * scene_l.av,
                            scene_l.v),
                w=jnp.where(fl, scene_l.w + 0.5 * dt * scene_l.aw,
                            scene_l.w),
            )
        if has_rigid:
            scene_l = rb._body_half_kick(scene_l, dt, two_d=False)
            scene_l = rb._particles_from_body_velocity(scene_l)
        return scene_l

    step = jax.jit(jax.shard_map(
        local_step_kdkf if kdkf else local_step, mesh=mesh,
        in_specs=(scene_spec, P()), out_specs=scene_spec,
        check_vma=False))
    return step


def shard_slab_scene(scene: Scene, mesh: Mesh) -> Scene:
    """device_put the slab-decomposed scene: particle rows over 'p',
    everything else replicated."""
    n = scene.n
    fields = {}
    for k, v in scene.fields.items():
        if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == n:
            spec = P("p", *([None] * (v.ndim - 1)))
        else:
            spec = P()
        fields[k] = jax.device_put(v, NamedSharding(mesh, spec))
    return Scene(fields, scene.meta)

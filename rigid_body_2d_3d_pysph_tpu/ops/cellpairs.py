"""Dense cell-block pair engine.

The padded ``[N, K]`` neighbor-list formulation (``neighbors.py``) does
one per-element gather per source field per pair.  This engine replaces
them with row gathers of whole cells and dense pair arithmetic:

1. particles are binned into a *bounded* grid (origin/dims fixed at
   setup from the initial AABB + slack), sorted by cell, and packed into
   a dense ``[NC_max, M, F]`` layout (cells padded to M lanes; empty
   lanes point at a sentinel row),
2. each occupied cell records its 9/27 neighbor cells' dense slots via a
   direct cell->slot table (no hashing, no binary search),
3. a pair pass processes cells in chunks: query block ``[C, M, F]``
   (slice), source block ``[C, O, M, F]`` (row gather), then all pair
   quantities as dense ``[C, M, O*M]`` arithmetic,
4. per-particle results return to original order through one small
   ``[N]`` gather.

The only remaining per-element operations are O(N) (sort keys, the
dense-slot scatter, the final unpack); the O(N*K) pair work is dense.
It evaluates more candidate lanes than there are true pairs
(``[C, M, O*M]`` per block), so which of the two engines is faster
depends on the device: ``config.select_engine`` holds the choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class CellGridConfig:
    cell: float                  # bin size ((cutoff + skin) / sub)
    M: int                       # dense-slot lane width (particles/slot)
    NC_max: int                  # max occupied slots (static)
    origin: tuple                # grid AABB min corner (3,)
    dims: tuple                  # cells per axis (3,), z=1 in 2D
    dim: int = 2
    cell_chunk: int = 512        # cells processed per map step
    cutoff: float = 0.0          # interaction radius (defaults to cell)
    sub: int = 1                 # bins per cutoff (stencil radius)
    skin: float = 0.0            # Verlet skin: grid rebuilt only when
    #                              max displacement since build > skin/2
    spill: bool = False          # slot spillover: a cell with > M
    #                              particles takes ceil(count/M)
    #                              CONSECUTIVE dense slots instead of
    #                              sizing M for the worst cell — lane
    #                              utilization stays high and occupancy
    #                              growth costs slots, not lanes
    nbr_width: int = 0           # packed stencil-slot table width
    #                              (spill mode; 0 -> len(stencil))
    max_spill: int = 4           # max slots per cell (spill mode)

    @property
    def O(self) -> int:
        return self.nbr_width if (self.spill and self.nbr_width)  \
            else len(self.stencil)

    @property
    def radius(self) -> float:
        return self.cutoff if self.cutoff > 0 else self.cell

    @property
    def stencil(self):
        r = tuple(range(-self.sub, self.sub + 1))
        if self.dim == 2:
            return tuple((dx, dy, 0) for dx in r for dy in r)
        return tuple((dx, dy, dz) for dx in r for dy in r for dz in r)

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.dims))


def config_from_positions(x, y, z, cutoff: float, dim: int,
                          slack: float = 0.75, M: int | None = None,
                          nc_factor: float = 1.6,
                          occupancy_safety: float = 1.5,
                          sub: int = 1,
                          cell_chunk: int = 512,
                          skin: float = 0.0,
                          spill: bool | None = None,
                          capacity_boost: float = 1.0) -> CellGridConfig:
    """Host-side: bound the domain from initial positions with ``slack``
    x extent margins; size M from measured occupancy and NC_max from the
    occupied-cell count.  ``sub`` bins per cutoff trades a wider stencil
    ((2*sub+1)^dim cells) for tighter candidate sets.  ``skin`` widens
    the bins so the grid stays valid until any particle has moved more
    than skin/2 since the build (Verlet-list reuse).

    ``capacity_boost`` scales every measured-occupancy slack factor
    (nc_factor, occupancy_safety, the spill stencil-width margin) —
    the Solver's overflow-rebuild path raises it when a configuration
    sized from one snapshot overflows as the particles spread
    (PySPH's NNPS resizes dynamically; here capacity is static per
    compiled program, so growth is a host-side rebuild)."""
    nc_factor = nc_factor * capacity_boost
    occupancy_safety = occupancy_safety * capacity_boost
    slack = slack * capacity_boost
    cell = (float(cutoff) + float(skin)) / sub
    x = np.asarray(x); y = np.asarray(y); z = np.asarray(z)
    pts = [x, y] + ([z] if dim == 3 else [])
    lo = np.array([p.min() for p in pts])
    hi = np.array([p.max() for p in pts])
    ext = np.maximum(hi - lo, cell)
    lo = lo - slack * ext - 2 * cutoff
    hi = hi + slack * ext + 2 * cutoff
    dims = [int(np.ceil((hi[i] - lo[i]) / cell)) + 2 * sub
            for i in range(len(lo))]
    if dim == 2:
        origin = (float(lo[0]), float(lo[1]), 0.0)
        dims = (dims[0], dims[1], 1)
    else:
        origin = (float(lo[0]), float(lo[1]), float(lo[2]))
        dims = (dims[0], dims[1], dims[2])

    cells = np.floor((np.stack([x, y, z], -1)
                      - np.array(origin)) / cell).astype(np.int64)
    if dim == 2:
        cells[:, 2] = 0
    uniq, counts = np.unique(cells, axis=0, return_counts=True)
    occ = counts.max()
    if spill is None:
        # spill mode keeps lanes narrow where the worst-cell occupancy
        # would otherwise size M for every cell (quintic 3D cells hold
        # ~60 particles, so the classic grid's lanes run mostly empty)
        spill = M is None and sub == 1
    if spill:
        if M is None:
            M = 16  # fixed lane width; occupancy growth costs SLOTS
        nsl = -(-counts // M)
        NC_max = max(64, int(np.ceil(nsl.sum() * nc_factor)))
        # packed stencil width: worst initial stencil slot-sum + slack
        occmap = {tuple(c): int(s) for c, s in zip(uniq, nsl)}
        r = range(-sub, sub + 1)
        worst = 0
        for c in map(tuple, uniq):
            s = sum(occmap.get((c[0] + i, c[1] + j, c[2] + k), 0)
                    for i in r for j in r
                    for k in (r if dim == 3 else (0,)))
            worst = max(worst, s)
        O_p = max(len(tuple(None for _ in r)) ** dim,
                  int(np.ceil(worst * 1.6 * capacity_boost)))
        return CellGridConfig(cell=cell, M=int(M), NC_max=NC_max,
                              origin=origin, dims=dims, dim=dim,
                              cell_chunk=cell_chunk, cutoff=float(cutoff),
                              sub=sub, skin=float(skin), spill=True,
                              nbr_width=int(O_p))
    if M is None:
        M = int(np.ceil(occ * occupancy_safety)) + 2
        M = max(8, -(-M // 8) * 8)  # multiples of 8 lanes
    nc = len(counts)
    NC_max = max(64, int(np.ceil(nc * nc_factor)))
    return CellGridConfig(cell=cell, M=int(M), NC_max=NC_max,
                          origin=origin, dims=dims, dim=dim,
                          cell_chunk=cell_chunk, cutoff=float(cutoff),
                          sub=sub, skin=float(skin))


class CellGrid(NamedTuple):
    slot2p: jax.Array     # [NC_max * M] original particle index; N = empty
    dense_pos: jax.Array  # [N] dense slot of particle i; NC_max*M = dropped
    nbr_slots: jax.Array  # [NC_max, O] neighbor cell slot; NC_max = none
    n_occupied: jax.Array  # scalar int32
    overflow: jax.Array   # scalar bool


def _cell_keys(x, y, z, active, cfg: CellGridConfig):
    """Linear cell id per particle (G = out-of-domain/inactive)."""
    inv = 1.0 / cfg.cell
    ox, oy, oz = cfg.origin
    gx, gy, gz = cfg.dims
    cx = jnp.floor((x - ox) * inv).astype(jnp.int32)
    cy = jnp.floor((y - oy) * inv).astype(jnp.int32)
    cz = (jnp.floor((z - oz) * inv).astype(jnp.int32)
          if cfg.dim == 3 else jnp.zeros_like(cx))
    sb = cfg.sub
    in_dom = ((cx >= sb) & (cx < gx - sb) & (cy >= sb) & (cy < gy - sb)
              & (cz >= (sb if cfg.dim == 3 else 0))
              & (cz < (gz - sb if cfg.dim == 3 else 1)))
    dom_overflow = jnp.any(active & ~in_dom)
    ok = active & in_dom

    G = cfg.n_cells_total
    cid = (cx + gx * (cy + gy * cz)).astype(jnp.int32)
    key = jnp.where(ok, cid, jnp.int32(G))  # inactive sort to the end
    return key, dom_overflow, G


def _stencil_rows(table, qcells, stencil, dims, G, sentinel):
    """``table[q + off]`` for every stencil offset as ONE wide row
    gather: the O shifted views of ``table`` are slices of a
    sentinel-padded copy (sequential, bandwidth-bound), stacked [G, O],
    and the query cells' rows are gathered once.  ``qcells == G`` rows
    (padding) come out all-sentinel."""
    gx, gy, gz = dims
    offs = [dx_ + gx * (dy_ + gy * dz_) for (dx_, dy_, dz_) in stencil]
    maxoff = max(abs(o) for o in offs)
    pad_lo = jnp.full((maxoff,), sentinel, jnp.int32)
    pad_hi = jnp.full((maxoff,), sentinel, jnp.int32)
    tp = jnp.concatenate([pad_lo, table.astype(jnp.int32), pad_hi])
    D = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(tp, maxoff + off, G) for off in offs],
        axis=1)                                          # [G, O]
    rows = D.at[jnp.clip(qcells, 0, G - 1)].get(mode="clip")  # [NC, O]
    return jnp.where((qcells < G)[:, None], rows, sentinel)


def build_cell_grid(x, y, z, active, cfg: CellGridConfig) -> CellGrid:
    n = x.shape[0]
    gx, gy, gz = cfg.dims
    key, dom_overflow, G = _cell_keys(x, y, z, active, cfg)

    idx = jnp.arange(n, dtype=jnp.int32)
    # sort_key_val: sorted keys come out of the sort itself (no separate
    # key[order] gather)
    ks, order = jax.lax.sort_key_val(key, idx)
    valid_s = ks < G

    head = valid_s & jnp.concatenate(
        [jnp.ones(1, bool), ks[1:] != ks[:-1]])
    if cfg.spill:
        return _finish_spill_grid(cfg, n, G, ks, order, valid_s, head, idx,
                                  dom_overflow)
    cslot = jnp.cumsum(head.astype(jnp.int32)) - 1        # [N] sorted order
    n_occ = jnp.where(jnp.any(valid_s), cslot[-1] + 1, 0)
    cell_overflow = n_occ > cfg.NC_max

    start = jax.lax.cummax(jnp.where(head, idx, -1))
    rank = idx - start
    lane_overflow = jnp.any(valid_s & (rank >= cfg.M))

    slot_ok = valid_s & (rank < cfg.M) & (cslot < cfg.NC_max)
    dense_pos_sorted = jnp.where(
        slot_ok, jnp.clip(cslot, 0, cfg.NC_max - 1) * cfg.M + rank,
        cfg.NC_max * cfg.M)

    # dense slot -> original particle (N-element scatter, unique indices)
    slot2p = jnp.full(cfg.NC_max * cfg.M + 1, n, jnp.int32).at[
        dense_pos_sorted].set(order.astype(jnp.int32), mode="drop",
                              unique_indices=True)[: cfg.NC_max * cfg.M]
    # original particle -> dense slot
    dense_pos = jnp.full(n, cfg.NC_max * cfg.M, jnp.int32).at[
        jnp.where(slot_ok, order, n)].set(dense_pos_sorted, mode="drop")

    # compact the occupied-cell heads to the front with a second sort,
    # which shrinks the cell2slot scatter below from N updates to NC_max
    key2 = jnp.where(head, cslot, jnp.int32(2 ** 30))
    _, cid_sorted = jax.lax.sort_key_val(key2, ks)
    if n < cfg.NC_max:  # fewer particles than cell slots (small shards)
        cid_sorted = jnp.concatenate(
            [cid_sorted, jnp.full(cfg.NC_max - n, G, jnp.int32)])
    slot_iota = jnp.arange(cfg.NC_max, dtype=jnp.int32)
    # per occupied cell: its linear cell id (compacted head particles)
    cell_cid = jnp.where(
        slot_iota < jnp.minimum(n_occ, cfg.NC_max),
        cid_sorted[: cfg.NC_max], -1)

    # cell id -> occupied slot table (direct addressing, no search)
    cell2slot = jnp.full(G + 1, cfg.NC_max, jnp.int32).at[
        jnp.where(cell_cid >= 0, cell_cid, G)].set(
            slot_iota, mode="drop")[:G]

    # neighbor slots per occupied cell: direct lookups.  One [NC]-row
    # wide gather through shifted slices instead of O gathers — see
    # _stencil_rows (cells on the domain boundary ring are excluded, so
    # the offset arithmetic never wraps rows).
    qcells = jnp.where(cell_cid >= 0, cell_cid, G)
    nbr_slots = _stencil_rows(cell2slot, qcells, cfg.stencil,
                              (gx, gy, gz), G, jnp.int32(cfg.NC_max))

    return CellGrid(slot2p=slot2p, dense_pos=dense_pos,
                    nbr_slots=nbr_slots, n_occupied=n_occ,
                    overflow=dom_overflow | cell_overflow | lane_overflow)


def _finish_spill_grid(cfg: CellGridConfig, n, G, ks, order, valid_s,
                       head, idx, dom_overflow):
    """Slot-spillover layout: a cell with count > M particles occupies
    ceil(count/M) CONSECUTIVE dense slots (every M-th particle of a cell
    starts a new slot), so M stays a narrow fixed lane width and
    occupancy growth costs slots instead of lanes.  The stencil table
    packs, per cell, the slot RUNS of its 9/27 neighbor cells into
    ``cfg.nbr_width`` entries (sentinel-tail padded); every slot of a
    cell shares its cell's row."""
    M = cfg.M
    NC = cfg.NC_max
    O_p = cfg.O
    stencil = cfg.stencil
    gx, gy, gz = cfg.dims

    start = jax.lax.cummax(jnp.where(head, idx, -1))
    rank = idx - start
    lane = rank % M
    subhead = valid_s & (lane == 0)
    vslot = jnp.cumsum(subhead.astype(jnp.int32)) - 1   # [N] sorted order
    n_occ = jnp.where(jnp.any(valid_s), vslot[-1] + 1, 0)
    cap_overflow = n_occ > NC

    slot_ok = valid_s & (vslot < NC)
    dense_pos_sorted = jnp.where(
        slot_ok, jnp.clip(vslot, 0, NC - 1) * M + lane, NC * M)
    slot2p = jnp.full(NC * M + 1, n, jnp.int32).at[
        dense_pos_sorted].set(order.astype(jnp.int32), mode="drop",
                              unique_indices=True)[: NC * M]
    dense_pos = jnp.full(n, NC * M, jnp.int32).at[
        jnp.where(slot_ok, order, n)].set(dense_pos_sorted, mode="drop")

    # compact occupied cells to the front: (cid, base slot); a cell's
    # slot count is the base DIFFERENCE to the next occupied cell, so no
    # per-cell count scan is needed
    n_cells = jnp.sum(head.astype(jnp.int32))
    key2 = jnp.where(head, vslot, jnp.int32(2 ** 30))
    comp = jax.lax.sort((key2, ks, vslot), num_keys=1)
    cid_c, base_c = comp[1], comp[2]
    if n < NC:
        padi = jnp.full(NC - n, G, jnp.int32)
        cid_c = jnp.concatenate([cid_c, padi])
        base_c = jnp.concatenate([base_c, jnp.zeros(NC - n, jnp.int32)])
    iota_nc = jnp.arange(NC, dtype=jnp.int32)
    cellmask = iota_nc < jnp.minimum(n_cells, NC)
    occ_cid = jnp.where(cellmask, cid_c[:NC], G)
    occ_base = jnp.where(cellmask, base_c[:NC], NC)
    base_ext = jnp.concatenate([base_c[1:NC + 1],
                                jnp.zeros(1, jnp.int32)])[:NC]
    base_nxt = jnp.where(iota_nc + 1 < jnp.minimum(n_cells, NC),
                         base_ext, n_occ)
    occ_nsl = jnp.where(cellmask,
                        jnp.clip(base_nxt - occ_base, 0, 2 ** 10), 0)
    spill_deep = jnp.any(occ_nsl > cfg.max_spill)

    # cell id -> packed (base*SH + nslots) direct-address table (ONE
    # [G] gather per stencil offset instead of two)
    SH = 32
    packed = jnp.full(G + 1, NC * SH, jnp.int32).at[occ_cid].set(
        occ_base * SH + jnp.minimum(occ_nsl, SH - 1), mode="drop")[:G]

    # packed per-CELL stencil table [NC, O9]: one gather of [NC]
    # O9-wide rows (see _stencil_rows) at the occupied cells.
    pv_all = _stencil_rows(packed, occ_cid, stencil, (gx, gy, gz), G,
                           jnp.int32(NC * SH))            # [NC, O9]
    nb_base = pv_all // SH
    nb_nsl = pv_all % SH
    pos = jnp.cumsum(nb_nsl, axis=1) - nb_nsl            # exclusive
    spill_ovf = jnp.any(pos[:, -1] + nb_nsl[:, -1] > O_p)

    tbl = jnp.full((NC, O_p), NC, jnp.int32)
    oi = jnp.arange(O_p, dtype=jnp.int32)[None]
    for o in range(len(stencil)):
        for j in range(cfg.max_spill):
            m = (j < nb_nsl[:, o:o + 1]) & (oi == pos[:, o:o + 1] + j)
            tbl = jnp.where(m, nb_base[:, o:o + 1] + j, tbl)

    # expand cell rows to slot rows (every slot of a cell shares its row)
    def cell2slot_expand(vals, fill=0):
        """Scatter per-cell values at their base slot, fill the run with
        cummax — valid whenever ``vals`` is nondecreasing over cells."""
        e = jnp.full(NC + 1, fill, jnp.int32).at[
            jnp.where(cellmask, jnp.clip(occ_base, 0, NC - 1), NC)
        ].set(vals.astype(jnp.int32), mode="drop")[:NC]
        return jax.lax.cummax(e)

    s2c = cell2slot_expand(iota_nc)
    nbr_slots = tbl[s2c]                                 # [NC, O_p]

    return CellGrid(slot2p=slot2p, dense_pos=dense_pos,
                    nbr_slots=nbr_slots, n_occupied=n_occ,
                    overflow=(dom_overflow | cap_overflow | spill_ovf
                              | spill_deep))


# ---------------------------------------------------------------------------
# packing / unpacking
# ---------------------------------------------------------------------------

def pack_fields(grid: CellGrid, cfg: CellGridConfig, fields, sentinels):
    """Pack per-particle [N] arrays into dense [NC_max, M, F].

    ``fields``: list of [N] arrays (same dtype); ``sentinels``: value per
    field used for empty lanes.  One [N+1, F] stack + one row gather.
    """
    stacked = jnp.stack(fields, axis=-1)  # [N, F]
    pad = jnp.asarray(sentinels, stacked.dtype)[None, :]
    ext = jnp.concatenate([stacked, pad], axis=0)  # [N+1, F]
    dense = ext[grid.slot2p]  # row gather -> [NC_max*M, F]
    return dense.reshape(cfg.NC_max, cfg.M, len(fields))


def pack_rows(grid: CellGrid, cfg: CellGridConfig, arr, sentinel=0.0):
    """Pack a per-particle [N, R] array into [NC_max, M, R]."""
    pad = jnp.full((1, arr.shape[1]), sentinel, arr.dtype)
    ext = jnp.concatenate([arr, pad], axis=0)
    dense = ext[grid.slot2p]
    return dense.reshape(cfg.NC_max, cfg.M, arr.shape[1])


def unpack(grid: CellGrid, cfg: CellGridConfig, dense, n: int, fill=0.0):
    """Dense [NC_max, M, R...] -> per-particle [N, R...] (original order).

    The gather runs in fill mode (sentinel ``dense_pos`` rows land on
    ``fill``) between optimization barriers: without the first, XLA may
    fuse the gather into its elementwise producers and re-evaluate them
    per gathered element; the second keeps downstream reshapes from
    fusing into the fill-mode gather."""
    flat = dense.reshape((cfg.NC_max * cfg.M,) + dense.shape[2:])
    flat = jax.lax.optimization_barrier(flat)
    out = flat.at[grid.dense_pos].get(mode="fill", fill_value=fill)
    return jax.lax.optimization_barrier(out)


def map_over_cells(cfg: CellGridConfig, fn, *dense_args):
    """Run ``fn(block_start, *sliced_blocks)`` over cell chunks and
    concatenate the outputs along the cell axis.  Each dense arg is
    [NC_max, ...]; fn receives [C, ...] slices."""
    C = cfg.cell_chunk
    nc_pad = -(-cfg.NC_max // C) * C
    padded = []
    for a in dense_args:
        if nc_pad != cfg.NC_max:
            pad_shape = (nc_pad - cfg.NC_max,) + a.shape[1:]
            fillv = cfg.NC_max if a.dtype == jnp.int32 else 0
            a = jnp.concatenate(
                [a, jnp.full(pad_shape, fillv, a.dtype)], axis=0)
        padded.append(a)
    n_blocks = nc_pad // C

    if n_blocks == 1:
        out = fn(jnp.int32(0), *padded)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        outs = tuple(o[: cfg.NC_max] for o in outs)
        return outs[0] if single else outs

    def body(i):
        start = i * C
        blocks = [jax.lax.dynamic_slice_in_dim(a, start, C, axis=0)
                  for a in padded]
        return fn(start, *blocks)

    out = jax.lax.map(body, jnp.arange(n_blocks, dtype=jnp.int32))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    merged = tuple(
        o.reshape((nc_pad,) + o.shape[2:])[: cfg.NC_max] for o in outs)
    return merged[0] if single else merged


def gather_source_block(dense, nbr_slots_block, cfg: CellGridConfig,
                        sentinel_row=None):
    """[NC_max, M, F] sources for a block's stencil: [C, O, M, F] via row
    gathers.  ``sentinel_row`` ([M, F] or scalar) fills missing-neighbor
    cells — it MUST make downstream gates false (e.g. far-away positions),
    zeros are only safe for pure accumulators."""
    if sentinel_row is None:
        sent = jnp.zeros((1,) + dense.shape[1:], dense.dtype)
    else:
        sent = jnp.broadcast_to(
            jnp.asarray(sentinel_row, dense.dtype), dense.shape[1:]
        )[None]
    ext = jnp.concatenate([dense, sent], axis=0)  # [NC_max+1, M, F]
    slots = jnp.minimum(nbr_slots_block, cfg.NC_max)
    return ext[slots]  # [C, O, M, F]

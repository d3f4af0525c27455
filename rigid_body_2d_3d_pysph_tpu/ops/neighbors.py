"""Fixed-capacity hash-grid neighbor search (the NNPS replacement).

Replaces PySPH's Cython LinkedList/Octree NNPS (implicit in every
reference pair loop through ``XIJ/RIJ/WIJ/DWIJ/NBRS``, e.g.
``code/rigid_body_common.py:663-690``, ``code/boundary_particles.py:44``)
with a fixed-capacity pipeline that runs entirely on device:

1. quantize positions to grid cells of size ``cutoff`` and hash the
   integer cell coordinates into a power-of-two bucket space,
2. ``argsort`` particles by bucket key (one ``lax.sort`` per rebuild),
3. for every particle, look up the 9 (2D) / 27 (3D) stencil cells with a
   batched binary search over the sorted keys,
4. verify candidates by *exact* integer cell coordinates (hash collisions
   produce no false pairs) and by distance <= cutoff,
5. compact candidates into a padded ``[N, K]`` neighbor list.

The list includes the particle itself (PySPH neighbor lists do too, and
several reference sums rely on the self contribution, e.g.
``SmoothNormals``).  Inactive particles get no neighbors and appear in
no one's list.

Overflow of the per-cell candidate cap or of K is detected and reported
(``overflow`` scalar) so drivers can fail loudly instead of silently
dropping pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_H1 = np.uint32(0x8DA6B343)
_H2 = np.uint32(0xD8163841)
_H3 = np.uint32(0xCB1AB31F)


class NeighborList(NamedTuple):
    idx: jax.Array  # [N, K] int32 neighbor indices (self included)
    mask: jax.Array  # [N, K] bool
    n_neighbors: jax.Array  # [N] int32
    overflow: jax.Array  # scalar bool


@dataclass(frozen=True)
class NeighborConfig:
    cutoff: float  # interaction radius == cell size
    max_neighbors: int  # K (compact mode only)
    max_per_cell: int  # M: candidate cap per stencil cell
    dim: int = 3
    n_buckets: int = 1 << 16  # power of two
    row_chunk: int = 4096  # rows processed per map step (memory bound)
    # compact=True packs candidates into [N, K] via a positional
    # scatter; the default keeps the padded [N, stencil*M] candidate
    # list and lets the (fully vectorized) pair ops mask it instead.
    compact: bool = False

    @property
    def stencil(self):
        r = (-1, 0, 1)
        if self.dim == 2:
            return tuple((dx, dy, 0) for dx in r for dy in r)
        return tuple((dx, dy, dz) for dx in r for dy in r for dz in r)


def _hash_cells(cx, cy, cz, n_buckets):
    k = (
        cx.astype(jnp.uint32) * _H1
        + cy.astype(jnp.uint32) * _H2
        + cz.astype(jnp.uint32) * _H3
    )
    return (k & jnp.uint32(n_buckets - 1)).astype(jnp.int32)


def default_config(dim: int, cutoff: float, n: int,
                   max_neighbors: int | None = None,
                   max_per_cell: int | None = None) -> NeighborConfig:
    """Heuristic capacities; callers should size from measured occupancy
    via :func:`estimate_capacities` when possible."""
    if max_per_cell is None:
        max_per_cell = 48 if dim == 2 else 96
    if max_neighbors is None:
        max_neighbors = 96 if dim == 2 else 160
    n_buckets = 1 << max(10, int(np.ceil(np.log2(max(2 * n, 2)))))
    return NeighborConfig(
        cutoff=float(cutoff),
        max_neighbors=int(max_neighbors),
        max_per_cell=int(max_per_cell),
        dim=dim,
        n_buckets=n_buckets,
    )


def estimate_capacities(x, y, z, cutoff: float, dim: int,
                        safety: float = 1.7) -> tuple[int, int]:
    """Host-side: measure initial cell occupancy / neighbor counts and
    derive (max_per_cell, max_neighbors) with headroom."""
    pos = np.stack([x, y, z if dim == 3 else np.zeros_like(x)], -1)
    cells = np.floor(pos / cutoff).astype(np.int64)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    m = int(np.ceil(counts.max() * safety)) + 2
    k_est = int(np.ceil(counts.max() * (9 if dim == 2 else 27) * 0.6 * safety))
    return m, max(k_est, 16)


def build_neighbors(x, y, z, active, cfg: NeighborConfig) -> NeighborList:
    """Build the padded neighbor list.  All inputs [N]; jit-friendly."""
    n = x.shape[0]
    inv = 1.0 / cfg.cutoff
    cx = jnp.floor(x * inv).astype(jnp.int32)
    cy = jnp.floor(y * inv).astype(jnp.int32)
    cz = (
        jnp.floor(z * inv).astype(jnp.int32)
        if cfg.dim == 3
        else jnp.zeros_like(cx)
    )

    key = _hash_cells(cx, cy, cz, cfg.n_buckets)
    # inactive particles sort to the very end with an out-of-range key
    key = jnp.where(active, key, jnp.int32(cfg.n_buckets))

    order = jnp.argsort(key)  # [N]
    skey = key[order]
    scx, scy, scz = cx[order], cy[order], cz[order]

    offsets = jnp.asarray(cfg.stencil, dtype=jnp.int32)  # [O, 3]
    n_off = offsets.shape[0]
    M, K = cfg.max_per_cell, cfg.max_neighbors

    def row_block(istart_block):
        idx_rows = istart_block + jnp.arange(cfg.row_chunk)
        idx_rows = jnp.minimum(idx_rows, n - 1)  # pad rows clamp (masked later)
        bx, by, bz = cx[idx_rows], cy[idx_rows], cz[idx_rows]
        bact = active[idx_rows]
        px = x[idx_rows]
        py = y[idx_rows]
        pz = z[idx_rows]

        # stencil cells for this block: [C, O]
        qx = bx[:, None] + offsets[None, :, 0]
        qy = by[:, None] + offsets[None, :, 1]
        qz = bz[:, None] + offsets[None, :, 2]
        qkey = _hash_cells(qx, qy, qz, cfg.n_buckets)

        lo = jnp.searchsorted(skey, qkey.ravel(), side="left").reshape(qkey.shape)
        hi = jnp.searchsorted(skey, qkey.ravel(), side="right").reshape(qkey.shape)
        run = hi - lo  # [C, O]
        cell_overflow = jnp.any(run > M)

        # candidate slots [C, O, M] in sorted space
        slots = lo[..., None] + jnp.arange(M)[None, None, :]
        valid = slots < hi[..., None]
        slots = jnp.minimum(slots, n - 1)

        cand_cx = scx[slots]
        cand_cy = scy[slots]
        cand_cz = scz[slots]
        cell_match = (cand_cx == qx[..., None]) & (cand_cy == qy[..., None])
        if cfg.dim == 3:
            cell_match &= cand_cz == qz[..., None]

        cand = order[slots]  # original indices
        dx = x[cand] - px[:, None, None]
        dy = y[cand] - py[:, None, None]
        dz = z[cand] - pz[:, None, None]
        r2 = dx * dx + dy * dy + dz * dz
        ok = (
            valid
            & cell_match
            & (r2 <= cfg.cutoff * cfg.cutoff)
            & active[cand]
            & bact[:, None, None]
        )

        ok_f = ok.reshape(cfg.row_chunk, n_off * M)
        cand_f = cand.reshape(cfg.row_chunk, n_off * M).astype(jnp.int32)
        count = jnp.sum(ok_f, axis=1).astype(jnp.int32)
        if not cfg.compact:
            return cand_f, ok_f, count, cell_overflow

        # compact [C, O*M] -> [C, K] (positional scatter; CPU path)
        pos_in_row = jnp.cumsum(ok_f.astype(jnp.int32), axis=1) - 1
        k_overflow = jnp.any(count > K)
        write = ok_f & (pos_in_row < K)
        dst = jnp.where(write, pos_in_row, K)  # K = scratch slot
        rows = jnp.broadcast_to(
            jnp.arange(cfg.row_chunk)[:, None], dst.shape
        )
        out_idx = jnp.zeros((cfg.row_chunk, K + 1), jnp.int32).at[
            rows, dst
        ].set(cand_f, mode="drop")[:, :K]
        out_mask = jnp.zeros((cfg.row_chunk, K + 1), bool).at[rows, dst].set(
            write, mode="drop"
        )[:, :K]
        return out_idx, out_mask, jnp.minimum(count, K), cell_overflow | k_overflow

    n_blocks = -(-n // cfg.row_chunk)
    k_out = K if cfg.compact else n_off * M
    if n_blocks == 1:
        idx, mask, cnt, ovf = row_block(jnp.int32(0))
        return NeighborList(idx=idx[:n], mask=mask[:n], n_neighbors=cnt[:n],
                            overflow=ovf)
    starts = jnp.arange(n_blocks) * cfg.row_chunk
    idx_b, mask_b, cnt_b, ovf_b = jax.lax.map(row_block, starts)
    idx = idx_b.reshape(n_blocks * cfg.row_chunk, k_out)[:n]
    mask = mask_b.reshape(n_blocks * cfg.row_chunk, k_out)[:n]
    cnt = cnt_b.reshape(n_blocks * cfg.row_chunk)[:n]
    return NeighborList(idx=idx, mask=mask, n_neighbors=cnt,
                        overflow=jnp.any(ovf_b))


def brute_force_neighbors(x, y, z, active, cutoff: float, max_neighbors: int
                          ) -> NeighborList:
    """O(N^2) oracle used by the tests (and tiny scenes)."""
    n = x.shape[0]
    pos = jnp.stack([x, y, z], -1)
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, -1)
    ok = (d2 <= cutoff * cutoff) & active[None, :] & active[:, None]
    pos_in_row = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
    count = pos_in_row[:, -1] + 1
    K = max_neighbors
    write = ok & (pos_in_row < K)
    dst = jnp.where(write, pos_in_row, K)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], dst.shape)
    cand = jnp.broadcast_to(jnp.arange(n)[None, :], dst.shape)
    idx = jnp.zeros((n, K + 1), jnp.int32).at[rows, dst].set(
        cand.astype(jnp.int32), mode="drop"
    )[:, :K]
    mask = jnp.zeros((n, K + 1), bool).at[rows, dst].set(write, mode="drop")[:, :K]
    return NeighborList(idx=idx, mask=mask, n_neighbors=jnp.minimum(count, K),
                        overflow=jnp.any(count > K))

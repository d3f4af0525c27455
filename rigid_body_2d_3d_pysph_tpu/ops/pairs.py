"""Shared helpers for neighbor-pair operators.

Every reference ``Equation.loop`` becomes: gather source fields at the
padded ``[N, K]`` neighbor indices, compute the pair quantities
(XIJ/RIJ/WIJ/DWIJ/VIJ/HIJ — the PySPH evaluator's implicit symbols, cf.
``code/rigid_body_common.py:663-690``), mask, and reduce over K (sums) or
scatter into ``[N, S]`` contact slots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .neighbors import NeighborList


class PairData(NamedTuple):
    j: jnp.ndarray      # [N, K] neighbor indices
    mask: jnp.ndarray   # [N, K] base validity
    xij: jnp.ndarray    # [N, K] x_i - x_j
    yij: jnp.ndarray
    zij: jnp.ndarray
    rij: jnp.ndarray    # [N, K] |xij|
    hij: jnp.ndarray    # [N, K] 0.5 (h_i + h_j)


def pair_data(scene, nbrs: NeighborList) -> PairData:
    j = nbrs.idx
    xij = scene.x[:, None] - scene.x[j]
    yij = scene.y[:, None] - scene.y[j]
    zij = scene.z[:, None] - scene.z[j]
    rij = jnp.sqrt(xij * xij + yij * yij + zij * zij)
    hij = 0.5 * (scene.h[:, None] + scene.h[j])
    return PairData(j=j, mask=nbrs.mask, xij=xij, yij=yij, zij=zij,
                    rij=rij, hij=hij)


def masked_sum(values, mask, axis=1):
    return jnp.sum(jnp.where(mask, values, 0.0), axis=axis)


def scatter_to_slots(values, slot, mask, n_slots: int):
    """Sum [N, K] pair values into [N, S] dem-id slots.

    Implements the reference's strided accumulation
    ``d_prop[d_idx * total_no_bodies + s_dem_id] += v``
    (e.g. ``code/rigid_body_common.py:681-690``).

    S (the dem entity count) is small and static, so this is computed
    as S dense masked reductions over K — elementwise work that XLA
    fuses, with no scatter and a fixed summation order.
    """
    vals = jnp.where(mask, values, 0.0)
    cols = [jnp.sum(jnp.where(slot == s, vals, 0.0), axis=1)
            for s in range(n_slots)]
    return jnp.stack(cols, axis=1)


def scatter_min_to_slots(values, slot, mask, n_slots: int, init):
    """Per-(particle, slot) minimum of [N, K] pair values; `init` is the
    starting value (reference inits closest-point distance to
    ``4 * spacing0``, ``code/rigid_body_common.py:765``).  Dense per-slot
    min-reductions (see scatter_to_slots)."""
    big = jnp.asarray(init, values.dtype)
    vals = jnp.where(mask, values, big)
    cols = [jnp.minimum(jnp.min(jnp.where(slot == s, vals, big), axis=1),
                        big)
            for s in range(n_slots)]
    return jnp.stack(cols, axis=1)


def argmin_to_slots(values, slot, mask, n_slots: int, init):
    """Per-(particle, slot): (min value, candidate position k of the
    first minimum, found flag).  Used for the closest-source-particle
    tracking (reference ``rigid_body_common.py:811-818``; ties resolve
    to the first candidate in neighbor order, like the reference's
    sequential scan)."""
    big = jnp.asarray(init, values.dtype)
    vals = jnp.where(mask, values, big)
    mins, args, founds = [], [], []
    for s in range(n_slots):
        v = jnp.where(slot == s, vals, big)
        k_star = jnp.argmin(v, axis=1)
        v_star = jnp.take_along_axis(v, k_star[:, None], axis=1)[:, 0]
        mins.append(jnp.minimum(v_star, big))
        args.append(k_star)
        founds.append(v_star < big)
    return (jnp.stack(mins, 1), jnp.stack(args, 1), jnp.stack(founds, 1))

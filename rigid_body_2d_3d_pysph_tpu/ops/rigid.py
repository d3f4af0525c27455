"""Rigid-body per-step ops: gravity load, per-body force/torque reduction,
and the batched body-frame linear algebra that replaces the reference's
host-Python ``py_stageN`` loops.

Reference equivalents:

* ``BodyForce``           — ``code/rigid_body_common.py:115-125``
* ``SumUpExternalForces`` — ``code/rigid_body_common.py:128-175`` (a
  host-serial Python reduce in the reference; here a ``segment_sum``)
* ``normalize_R_orientation`` — ``code/rigid_body_common.py:178-203``
  (Gram-Schmidt on the columns, exact same ordering)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_body_rows(arr, bid, nb: int, valid=None):
    """``arr[bid]`` for per-body state ``arr [B, ...]`` via a one-hot
    [N,B]x[B,F] contraction (B is small: the bodies of one scene).
    Exact: the one-hot row has a single 1, so the sum is the gathered
    value bit-for-bit.  ``valid=False`` rows return zeros."""
    n = bid.shape[0]
    oh = bid[:, None] == jnp.arange(nb, dtype=bid.dtype)[None, :]
    if valid is not None:
        oh = oh & valid[:, None]
    ohf = oh.astype(arr.dtype)
    flat = arr.reshape(nb, -1)
    # HIGHEST precision is required for the exactness promise above: at
    # DEFAULT, XLA:GPU may run the f32 product in TF32, rounding the
    # gathered xcm/R values to a 10-bit mantissa.
    out = jnp.einsum("nb,bf->nf", ohf, flat,
                     preferred_element_type=arr.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape((n,) + arr.shape[1:])


def body_force(scene, gx: float, gy: float, gz: float, dest_mask):
    """f_i = m_i * g for destination particles; zero elsewhere.

    The reference's ``BodyForce.initialize`` *sets* (not accumulates) the
    per-particle force, so this op also serves as the per-eval force
    reset (scheme group ordering: ``code/rigid_body_3d.py:669-678``).
    """
    m = jnp.where(dest_mask, scene.m, 0.0)
    return m * gx, m * gy, m * gz


def sum_up_external_forces(scene, fx, fy, fz):
    """Per-body total force and torque about the COM.

    ``frc[b] = sum_i f_i;  trq[b] = sum_i (r_i - xcm_b) x f_i``
    (reference :155-175).  Non-rigid particles carry body_id slots that
    are clamped to 0 with zero force, so they contribute nothing.
    """
    nb = scene.meta.nb
    rigid = scene.is_rigid & scene.active
    bid = jnp.where(rigid, scene.body_id, 0)
    fx = jnp.where(rigid, fx, 0.0)
    fy = jnp.where(rigid, fy, 0.0)
    fz = jnp.where(rigid, fz, 0.0)

    xcm_p = gather_body_rows(scene.xcm, bid, nb)  # [N, 3]
    dx = scene.x - xcm_p[:, 0]
    dy = scene.y - xcm_p[:, 1]
    dz = scene.z - xcm_p[:, 2]

    tx = dy * fz - dz * fy
    ty = dz * fx - dx * fz
    tz = dx * fy - dy * fx

    # With few bodies the per-body sum is a one-hot [N,B]x[N,6]
    # contraction, which keeps the summation order fixed from run to run
    # (a scatter-add's order is not).
    oh = ((bid[:, None] == jnp.arange(nb)[None, :]) & rigid[:, None]
          ).astype(fx.dtype)  # [N, B]
    vec = jnp.stack([fx, fy, fz, tx, ty, tz], axis=-1)  # [N, 6]
    # HIGHEST precision: force/torque sums over a settled body cancel
    # almost exactly, so operands rounded to TF32 (the DEFAULT f32
    # product on the GPU) would leave a large relative error.
    tot = jnp.einsum("nb,nc->bc", oh, vec,
                     preferred_element_type=vec.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    return tot[:, :3], tot[:, 3:]


def gram_schmidt_columns(R):
    """Re-orthonormalize rotation matrices [B,3,3] column by column, in
    the reference's exact order (col0 -> col1 -> col2,
    ``rigid_body_common.py:179-203``)."""
    a1 = R[..., :, 0]
    a2 = R[..., :, 1]
    a3 = R[..., :, 2]
    b1 = a1 / jnp.linalg.norm(a1, axis=-1, keepdims=True)
    b2 = a2 - jnp.sum(b1 * a2, -1, keepdims=True) * b1
    b2 = b2 / jnp.linalg.norm(b2, axis=-1, keepdims=True)
    b3 = (
        a3
        - jnp.sum(b1 * a3, -1, keepdims=True) * b1
        - jnp.sum(b2 * a3, -1, keepdims=True) * b2
    )
    b3 = b3 / jnp.linalg.norm(b3, axis=-1, keepdims=True)
    return jnp.stack([b1, b2, b3], axis=-1)


def omega_cross_matrix(om):
    """[B,3] -> [B,3,3] skew matrices Omega such that Omega @ v = om x v
    (reference ``rigid_body_3d.py:108-110``)."""
    z = jnp.zeros_like(om[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -om[..., 2], om[..., 1]], -1),
            jnp.stack([om[..., 2], z, -om[..., 0]], -1),
            jnp.stack([-om[..., 1], om[..., 0], z], -1),
        ],
        axis=-2,
    )


def rotate_body_frame_vectors(R, bid, vx, vy, vz):
    """dr = R[bid] @ (vx, vy, vz) per particle; returns (dx, dy, dz).

    This is the per-particle position rotation of every stepper stage
    (``rigid_body_3d.py:76-81`` and friends).
    """
    Rb = gather_body_rows(R, bid, R.shape[0])  # [N, 3, 3]
    dx = Rb[:, 0, 0] * vx + Rb[:, 0, 1] * vy + Rb[:, 0, 2] * vz
    dy = Rb[:, 1, 0] * vx + Rb[:, 1, 1] * vy + Rb[:, 1, 2] * vz
    dz = Rb[:, 2, 0] * vx + Rb[:, 2, 1] * vy + Rb[:, 2, 2] * vz
    return dx, dy, dz

"""Accelerator-native rigid-body / DEM / SPH-FSI particle framework.

A from-scratch JAX/XLA re-design of the capabilities of
dineshadepu/rigid_body_2d_3d_pysph (which is built on PySPH's
Cython code-generation stack).  Everything hot runs on device under a
single ``jax.jit`` step:

* particle state is a fixed-capacity SoA pytree (``state.Scene``)
  replacing PySPH's ``ParticleArray`` (reference: pysph.base.utils
  ``get_particle_array``, used e.g. at ``code/rigid_body_3d.py:15``),
* neighbor search is a sorted hash-grid producing padded ``[N, K]``
  neighbor lists (replacing PySPH's Cython NNPS cell lists),
* every reference ``Equation`` becomes a pure vectorized op in ``ops/``,
* the per-body host Python ``py_stageN`` updates of the reference
  (``code/rigid_body_3d.py:41-60,97-132,171-190``) become batched
  on-device linear algebra inside the integrator,
* multi-chip scaling uses ``jax.sharding``/``shard_map`` (``parallel/``).

The public surface mirrors the reference's scheme/application layer so a
PySPH user of the reference repo can map each concept 1:1.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

"""Multi-chip SPMD execution via ``jax.sharding`` + GSPMD.

The reference's only in-run parallelism is OpenMP loop-parallelism over
destination particles (``automate.py:17-19``; SURVEY.md §2.3).  The
scaling axis here is the same — particles — mapped onto a 1-D
device mesh:

* every ``[N, ...]`` particle field is sharded on axis 0 (``P('p')``),
* per-body state ``[B, ...]`` is replicated (bodies are few); the
  ``segment_sum`` force/torque reduction becomes a per-shard partial sum
  + ``AllReduce`` which XLA inserts automatically,
* neighbor search gathers by global index; GSPMD turns the remote-row
  gathers into all-gathers over the device interconnect.

We deliberately use the "annotate shardings, let XLA insert collectives"
recipe (jit with in/out shardings) rather than hand-written
``shard_map`` ping-pong: the step is a single fused program and the
partitioner already emits the minimal collective set for it.

``pad_scene`` rounds N up to a multiple of the mesh size with inactive
far-away particles (static shapes; the ``active`` mask keeps them out of
every neighbor list and reduction).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state.scene import Scene, SceneMeta


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("p",))


def pad_scene(scene: Scene, multiple: int) -> Scene:
    """Pad particle arrays to a multiple of the mesh size with inactive
    sentinel particles parked far outside the domain."""
    n = scene.n
    n_pad = (-n) % multiple
    if n_pad == 0:
        return scene
    new_fields = {}
    far = 1.0e6
    for k, v in scene.fields.items():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == n:
            pad_shape = (n_pad,) + arr.shape[1:]
            if k in ("x", "y", "z"):
                pad = np.full(pad_shape, far, arr.dtype)
            elif k in ("m", "rho", "h", "moi"):
                pad = np.ones(pad_shape, arr.dtype)
            elif k == "active":
                pad = np.zeros(pad_shape, bool)
            elif arr.dtype == np.int32 and k in ("tng_idx", "tng_idx_dem_id"):
                pad = np.full(pad_shape, -1, arr.dtype)
            else:
                pad = np.zeros(pad_shape, arr.dtype)
            new_fields[k] = jnp.asarray(np.concatenate([arr, pad]))
        else:
            new_fields[k] = v
    return Scene(new_fields, scene.meta)


def scene_shardings(scene: Scene, mesh: Mesh):
    """NamedSharding pytree: particle-axis arrays -> P('p'), rest
    replicated."""
    n = scene.n
    shardings = {}
    for k, v in scene.fields.items():
        if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == n:
            spec = P("p", *([None] * (v.ndim - 1)))
        else:
            spec = P()
        shardings[k] = NamedSharding(mesh, spec)
    return shardings


def shard_scene(scene: Scene, mesh: Mesh) -> Scene:
    """device_put the scene with the particle-axis layout."""
    scene = pad_scene(scene, mesh.devices.size)
    sh = scene_shardings(scene, mesh)
    fields = {k: jax.device_put(v, sh[k]) for k, v in scene.fields.items()}
    return Scene(fields, scene.meta)


def make_sharded_step(scheme, scene: Scene, mesh: Mesh):
    """jit the scheme's fused step with explicit in/out shardings over
    the mesh.  The scene must already be padded/sharded
    (:func:`shard_scene`)."""
    base_step = scheme.make_step(scene)
    sh = scene_shardings(scene, mesh)

    def spec_of(tree):
        # Scene flattens to (sorted field values, (keys, meta)); map the
        # dict shardings onto that ordering.
        keys = sorted(scene.fields.keys())
        return Scene({k: sh[k] for k in keys}, scene.meta)

    sharded = jax.jit(
        base_step,
        in_shardings=(spec_of(scene), None),
        out_shardings=spec_of(scene),
    )
    return sharded

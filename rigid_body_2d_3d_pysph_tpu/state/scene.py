"""Particle + rigid-body state as a fixed-shape SoA pytree.

This replaces PySPH's Cython ``ParticleArray`` (reference:
``get_particle_array`` imports at ``code/rigid_body_3d.py:15``,
``add_property(stride=...)`` / ``add_constant`` calls at
``code/rigid_body_3d.py:729-841``) with an accelerator-native design:

* All named particle arrays of a simulation ("body", "tank", "fluid",
  ...) are concatenated into ONE Scene so a single sorted hash grid and a
  single jitted step cover every interaction.  Group identity survives as
  a static table of index ranges (``GroupSpec``) plus per-particle role
  masks.
* The reference's flat per-body constants (``xcm`` as ``[3*nb]``, ``R``
  as ``[9*nb]``, ``rigid_body_3d.py:781-828``) become shaped arrays:
  ``xcm [B,3]``, ``R [B,3,3]``, ``inertia_* [B,3,3]``, ``eta [B,S]``.
* The reference's strided contact-slot properties (stride =
  ``total_no_bodies``, ``rigid_body_3d.py:739-771``) become ``[N,S]`` /
  ``[N,S,3]`` arrays where ``S = total_no_bodies``.

Fields live in a plain dict, the Scene is a registered pytree, and all
shapes are static per compiled step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config

# Particle roles (mirrors the reference's scheme argument lists:
# rigid_bodies / boundaries / fluids, e.g. ``code/rigid_body_3d.py:579``).
ROLE_RIGID = "rigid"
ROLE_BOUNDARY = "boundary"
ROLE_FLUID = "fluid"


@dataclass(frozen=True)
class GroupSpec:
    """Static description of one named particle array inside the Scene."""

    name: str
    start: int
    stop: int
    role: str
    # per-array material constants of the reference (e.g. E, poisson_ratio
    # set in the benchmark apps: ``code/benchmark_1...py:86-90``)
    constants: Tuple[Tuple[str, float], ...] = ()

    @property
    def size(self) -> int:
        return self.stop - self.start

    def const(self, key: str, default: float = 0.0) -> float:
        for k, v in self.constants:
            if k == key:
                return v
        return default


@dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene metadata baked into the compiled step."""

    dim: int
    groups: Tuple[GroupSpec, ...]
    nb: int  # number of rigid bodies (global, across all rigid groups)
    total_no_bodies: int  # S: contact slot count (reference `total_no_bodies`)
    spacing0: float  # reference `spacing0` constant (contact rest distance)

    def group(self, name: str) -> GroupSpec:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def groups_with_role(self, role: str) -> Tuple[GroupSpec, ...]:
        return tuple(g for g in self.groups if g.role == role)

    @property
    def n(self) -> int:
        return max(g.stop for g in self.groups) if self.groups else 0


@jax.tree_util.register_pytree_node_class
class Scene:
    """SoA particle/body state.  Immutable; use ``replace``/``with_fields``."""

    def __init__(self, fields: Dict[str, Any], meta: SceneMeta):
        object.__setattr__(self, "fields", fields)
        object.__setattr__(self, "meta", meta)

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        keys = tuple(sorted(self.fields.keys()))
        children = tuple(self.fields[k] for k in keys)
        return children, (keys, self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, meta = aux
        return cls(dict(zip(keys, children)), meta)

    # -- access ----------------------------------------------------------
    def __getattr__(self, k):
        try:
            return self.fields[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __getitem__(self, k):
        return self.fields[k]

    def __contains__(self, k):
        return k in self.fields

    @property
    def n(self) -> int:
        return self.fields["x"].shape[0]

    # -- functional updates ---------------------------------------------
    def replace(self, **kw) -> "Scene":
        new = dict(self.fields)
        for k, v in kw.items():
            if k not in new:
                raise KeyError(f"unknown field {k!r}; use with_fields to add")
            new[k] = v
        return Scene(new, self.meta)

    def with_fields(self, **kw) -> "Scene":
        new = dict(self.fields)
        new.update(kw)
        return Scene(new, self.meta)

    def replace_meta(self, meta: SceneMeta) -> "Scene":
        return Scene(dict(self.fields), meta)

    # -- host-side convenience (tests / IO) ------------------------------
    def group_view(self, name: str) -> Dict[str, np.ndarray]:
        g = self.meta.group(name)
        out = {}
        for k, v in self.fields.items():
            arr = np.asarray(v)
            if arr.ndim >= 1 and arr.shape[0] == self.n:
                out[k] = arr[g.start : g.stop]
        return out


@dataclass
class GroupArrays:
    """Host-side staging container for one named particle array, mirroring
    the reference's ``get_particle_array(...)`` calls."""

    name: str
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    m: np.ndarray
    h: np.ndarray
    rho: np.ndarray
    rad_s: np.ndarray
    role: str = ROLE_RIGID
    body_id: Optional[np.ndarray] = None  # local per-array body ids
    dem_id: Optional[np.ndarray] = None
    constants: Dict[str, float] = dataclasses.field(default_factory=dict)
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.x)


def make_group(
    name: str,
    x,
    y,
    z=None,
    m=None,
    h=None,
    rho=None,
    rad_s=None,
    role: str = ROLE_RIGID,
    body_id=None,
    dem_id=None,
    constants: Optional[Dict[str, float]] = None,
    **extra,
) -> GroupArrays:
    """Build a staging group; scalars broadcast like PySPH's
    ``get_particle_array`` (reference usage ``code/benchmark_1...py:83-90``)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64)).ravel()
    n = len(x)

    def _arr(v, default=0.0):
        if v is None:
            return np.full(n, default, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        return np.full(n, float(v), dtype=np.float64) if v.ndim == 0 else v.ravel()

    y = _arr(y)
    z = _arr(z)
    m = _arr(m, 1.0)
    h = _arr(h, 1.0)
    rho = _arr(rho, 1.0)
    rad_s = _arr(rad_s, 0.0)

    def _iarr(v):
        if v is None:
            return None
        v = np.asarray(v, dtype=np.int32)
        return np.full(n, int(v), dtype=np.int32) if v.ndim == 0 else v.ravel()

    return GroupArrays(
        name=name,
        x=x,
        y=y,
        z=z,
        m=m,
        h=h,
        rho=rho,
        rad_s=rad_s,
        role=role,
        body_id=_iarr(body_id),
        dem_id=_iarr(dem_id),
        constants=dict(constants or {}),
        extra={k: np.asarray(v) for k, v in extra.items()},
    )


def build_scene(
    groups,
    dim: int,
    total_no_bodies: Optional[int] = None,
    spacing0: float = 0.0,
) -> Scene:
    """Concatenate staging groups into a Scene with core fields.

    Rigid groups get global body indices: each rigid group's local
    ``body_id`` is offset by the number of bodies in preceding rigid
    groups (the reference keeps per-array body state instead:
    ``code/rigid_body_3d.py:781-828``; merging is the single-jit
    equivalent and preserves dem_id slot semantics).
    """
    fdt = config.float_dtype()
    idt = np.int32

    specs = []
    offset = 0
    body_offset = 0
    cat: Dict[str, list] = {
        "x": [], "y": [], "z": [], "u": [], "v": [], "w": [],
        "m": [], "h": [], "rho": [], "rad_s": [], "p": [],
        "body_id": [], "dem_id": [], "group_id": [],
        "is_rigid": [], "is_static_boundary": [], "is_fluid": [],
    }
    extra_cat: Dict[str, list] = {}

    for gi, g in enumerate(groups):
        n = g.size
        specs.append(
            GroupSpec(
                name=g.name,
                start=offset,
                stop=offset + n,
                role=g.role,
                constants=tuple(sorted(g.constants.items())),
            )
        )
        cat["x"].append(g.x)
        cat["y"].append(g.y)
        cat["z"].append(g.z)
        cat["u"].append(np.zeros(n))
        cat["v"].append(np.zeros(n))
        cat["w"].append(np.zeros(n))
        cat["m"].append(g.m)
        cat["h"].append(g.h)
        cat["rho"].append(g.rho)
        cat["rad_s"].append(g.rad_s)
        cat["p"].append(g.extra.pop("p", np.zeros(n)))

        if g.role == ROLE_RIGID:
            local_bid = g.body_id if g.body_id is not None else np.zeros(n, idt)
            gbid = local_bid.astype(idt) + body_offset
            body_offset += int(local_bid.max()) + 1
        else:
            gbid = np.full(n, -1, idt)
        cat["body_id"].append(gbid)

        dem = g.dem_id if g.dem_id is not None else np.zeros(n, idt)
        cat["dem_id"].append(dem.astype(idt))
        cat["group_id"].append(np.full(n, gi, idt))
        cat["is_rigid"].append(np.full(n, g.role == ROLE_RIGID, bool))
        cat["is_static_boundary"].append(np.full(n, g.role == ROLE_BOUNDARY, bool))
        cat["is_fluid"].append(np.full(n, g.role == ROLE_FLUID, bool))

        for k, v in g.extra.items():
            extra_cat.setdefault(k, [(gi, v)])
            if extra_cat[k][-1][0] != gi:
                extra_cat[k].append((gi, v))

        offset += n

    nb = body_offset
    if total_no_bodies is None:
        all_dem = np.concatenate(cat["dem_id"]) if cat["dem_id"] else np.zeros(0, idt)
        total_no_bodies = int(all_dem.max()) + 1 if len(all_dem) else 1

    fields: Dict[str, Any] = {}
    for k, vs in cat.items():
        arr = np.concatenate(vs) if vs else np.zeros(0)
        if k in ("body_id", "dem_id", "group_id"):
            fields[k] = jnp.asarray(arr, dtype=jnp.int32)
        elif k.startswith("is_"):
            fields[k] = jnp.asarray(arr, dtype=bool)
        else:
            fields[k] = jnp.asarray(arr, dtype=fdt)

    # extras: scatter group-local arrays into full-length arrays (zeros else)
    ntot = offset
    for k, pieces in extra_cat.items():
        sample = pieces[0][1]
        full = np.zeros((ntot,) + sample.shape[1:], dtype=np.float64)
        for gi, v in pieces:
            s = specs[gi]
            full[s.start : s.stop] = v
        fields[k] = jnp.asarray(full, dtype=fdt)

    fields["active"] = jnp.ones(ntot, dtype=bool)

    meta = SceneMeta(
        dim=dim,
        groups=tuple(specs),
        nb=nb,
        total_no_bodies=int(total_no_bodies),
        spacing0=float(spacing0),
    )
    return Scene(fields, meta)

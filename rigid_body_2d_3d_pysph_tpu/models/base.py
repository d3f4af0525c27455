"""Scheme base class and SchemeChooser.

Mirrors the reference's config plumbing: PySPH ``Scheme`` subclasses with
``add_user_options / consume_user_options / get_equations /
configure_solver / setup_properties`` (e.g. ``code/rigid_body_3d.py:578``)
and ``SchemeChooser`` (used by every benchmark app, e.g.
``code/benchmark_1...py:120-124``).

In this framework a scheme owns:
* ``setup(scene, ...)``        — host-side state attachment (the
  ``setup_properties`` equivalent),
* ``make_step()``              — returns a jitted ``step(scene, dt)``
  implementing one full integrator timestep (the equation groups +
  stepper stages fused into a single device program),
* velocity-setting APIs matching the reference's
  (``set_linear_velocity`` / ``set_angular_velocity``).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from .. import config
from ..ops import neighbors as nbmod
from ..state.scene import Scene


class Scheme:
    name = "scheme"

    #: slack multiplier applied to every measured-occupancy capacity
    #: (cell slots, lane width, neighbor-list K, spill stencil width).
    #: The Solver's overflow-rebuild path raises it when a grid sized
    #: from one snapshot overflows as the simulation spreads.
    capacity_boost = 1.0

    _engine: Optional[str] = None

    @property
    def engine(self) -> str:
        """The pair engine this scheme runs (``config.ENGINES``):
        ``config.select_engine()`` unless set explicitly.  Setting an
        unknown engine raises."""
        if self._engine is None:
            self._engine = config.select_engine()
        return self._engine

    @engine.setter
    def engine(self, name: str) -> None:
        self._engine = config.check_engine(name)

    def add_user_options(self, group: argparse._ArgumentGroup) -> None:
        pass

    def consume_user_options(self, options: argparse.Namespace) -> None:
        pass

    def configure(self, **kw) -> None:
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"{type(self).__name__} has no option {k!r}")
            setattr(self, k, v)

    # solver configuration (dt/tf/pfreq), mirroring configure_solver kwargs
    def configure_solver(self, dt: float, tf: float, pfreq: int = 100,
                         **kw) -> None:
        self.dt = float(dt)
        self.tf = float(tf)
        self.pfreq = int(pfreq)
        for k, v in kw.items():
            setattr(self, k, v)

    def setup(self, scene: Scene, **kw) -> Scene:
        raise NotImplementedError

    def make_step(self, scene: Scene):
        raise NotImplementedError

    def refresh_configs(self, scene: Scene, grow: bool = False) -> None:
        """Drop every cached neighbor/cell-grid config so the next
        ``make_step`` re-sizes capacities from the CURRENT particle
        positions.  ``grow=True`` additionally widens all slack factors
        1.5x — used by the Solver when a rebuild from the same snapshot
        overflowed again (the spread within one chunk exceeded the
        default margins).  PySPH's NNPS resizes its arrays dynamically
        (reference: pysph.base.nnps usage throughout ``code/``); with
        XLA's static shapes, growth is this host-side rebuild plus a
        re-jit of the step."""
        if grow:
            self.capacity_boost = float(self.capacity_boost) * 1.5
        for attr in ("_nbr_cfg", "_cell_cfg"):
            if getattr(self, attr, None) is not None:
                setattr(self, attr, None)

    # -- shared helpers ---------------------------------------------------
    def neighbor_config(self, scene: Scene, radius_scale: float,
                        safety: float = 2.0) -> nbmod.NeighborConfig:
        x = np.asarray(scene.x)
        y = np.asarray(scene.y)
        z = np.asarray(scene.z)
        h = np.asarray(scene.h)
        cutoff = float(radius_scale * h.max())
        m, k = nbmod.estimate_capacities(x, y, z, cutoff, scene.meta.dim,
                                         safety=safety * self.capacity_boost)
        cfg = nbmod.default_config(scene.meta.dim, cutoff, scene.n,
                                   max_neighbors=k, max_per_cell=m)
        return cfg


class SchemeChooser(Scheme):
    """Selects one of several schemes by CLI flag (reference: PySPH
    ``SchemeChooser``, used at ``code/benchmark_1...py:120-124``)."""

    def __init__(self, default: str, **schemes: Scheme):
        self.schemes: Dict[str, Scheme] = dict(schemes)
        self.default = default
        self.scheme: Scheme = self.schemes[default]

    def select(self, name: Optional[str]) -> Scheme:
        if name:
            self.scheme = self.schemes[name]
        return self.scheme

    def add_user_options(self, group) -> None:
        group.add_argument("--scheme", default=self.default,
                           choices=sorted(self.schemes.keys()),
                           help="Scheme to use")

        class _Dedup:
            """Schemes often share option names (e.g. --kr-stiffness in
            both rb2d and rb3d); add each flag once."""

            def __init__(self, g):
                self._g = g
                self._seen = set()

            def add_argument(self, *a, **kw):
                if a and a[0] in self._seen:
                    return None
                self._seen.add(a[0] if a else None)
                return self._g.add_argument(*a, **kw)

        dg = _Dedup(group)
        for s in self.schemes.values():
            s.add_user_options(dg)

    def consume_user_options(self, options) -> None:
        self.select(getattr(options, "scheme", None))
        self.scheme.consume_user_options(options)

    # explicit delegation of the solver-facing surface
    def setup(self, scene, **kw):
        return self.scheme.setup(scene, **kw)

    def make_step(self, scene):
        return self.scheme.make_step(scene)

    def refresh_configs(self, scene, grow: bool = False):
        # MUST delegate explicitly: the inherited implementation would
        # setattr the cleared configs onto the CHOOSER (shadowing
        # __getattr__) while the selected scheme kept its stale grid —
        # the Solver's overflow rebuild would then silently re-use the
        # overflowing config forever
        return self.scheme.refresh_configs(scene, grow=grow)

    @property
    def engine(self):
        # explicit: the inherited property would shadow the scheme's
        return self.scheme.engine

    @engine.setter
    def engine(self, name):
        self.scheme.engine = name

    @property
    def capacity_boost(self):
        # class attr on Scheme, so __getattr__ never fires for it
        return self.scheme.capacity_boost

    def configure_solver(self, dt, tf, pfreq=100, **kw):
        self.scheme.configure_solver(dt, tf, pfreq, **kw)

    def __getattr__(self, k):
        # delegate everything else to the active scheme
        return getattr(self.__dict__["scheme"], k)

"""Application driver: CLI, solver loop, output, hooks.

Replaces PySPH's ``Application`` / ``Solver`` layer (reference usage:
``app.run()`` at ``code/benchmark_1...py:182-183``, ``configure_solver``
with dt/tf/pfreq at ``:129``, ``post_step`` wall-motion hook at
``code/stack_of_cylinders.py:438-445``).

Key difference from PySPH: the hot loop runs in device-resident chunks
(``lax.scan`` over the fused jitted step — zero host round-trips inside a
chunk), with host work (snapshots, scheduled events, overflow checks)
only at chunk boundaries.  Reference-style ``post_step`` logic becomes
*scheduled events*: (time, callback) pairs applied on the host at the
nearest step boundary, which is what the reference's time-window check
``(T - dt/2) < t < (T + dt/2)`` implements anyway.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..models.rigid_body import make_multi_step
from ..state.scene import Scene
from . import checkpoint as ckpt_mod
from . import output as out_mod


class Solver:
    """Owns the time loop.  ``scheme.make_step(scene)`` supplies the fused
    per-step device program."""

    def __init__(self, scheme, scene: Scene, dt: float, tf: float,
                 pfreq: int = 100, output_dir: str = "output",
                 output_fields: Optional[Sequence[str]] = None,
                 events: Sequence[Tuple[float, Callable]] = (),
                 detailed_output: bool = False,
                 checkpoint_every: int = 10):
        self.scheme = scheme
        self.scene = scene
        self.dt = float(dt)
        self.tf = float(tf)
        self.pfreq = int(pfreq)
        self.output_dir = output_dir
        self.output_fields = output_fields
        self.events = sorted(events, key=lambda e: e[0])
        self.t = 0.0
        self.count = 0
        self.output_files: List[str] = []
        self.callbacks_post_chunk: List[Callable] = []
        self._steps_per_sec = 0.0
        self._writer = None  # lazy AsyncSnapshotWriter
        # resume granularity: a checkpoint costs a full-state host
        # transfer + npz write, so take one every N output chunks (the
        # final chunk always checkpoints)
        self.checkpoint_every = max(1, int(checkpoint_every))

    # -- helpers ----------------------------------------------------------
    def _dump(self):
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir,
                            f"snapshot_{self.count:06d}.npz")
        # The device->host transfer + npz write run on a background
        # thread (JAX arrays are immutable, so the step loop keeps going
        # while the worker fetches).
        if os.environ.get("RB_SYNC_SNAPSHOTS"):
            out_mod.write_snapshot(path, self.scene, self.t, self.dt,
                                   self.count, self.output_fields)
        else:
            if self._writer is None:
                self._writer = out_mod.AsyncSnapshotWriter()
            self._writer.submit(path, self.scene, self.t, self.dt,
                                self.count, self.output_fields)
        self.output_files.append(path)

    def _overflowed(self) -> bool:
        return "nbr_overflow" in self.scene and bool(
            np.asarray(self.scene.nbr_overflow))

    def solve(self, quiet: bool = False, resume: bool = False):
        step = self.scheme.make_step(self.scene)
        n_steps = int(round(self.tf / self.dt))
        multi = make_multi_step(step, self.pfreq)

        done = 0
        if resume:
            cp = ckpt_mod.latest_checkpoint(self.output_dir)
            if cp:
                self.scene, self.t, done = ckpt_mod.load_checkpoint(
                    cp, self.scene)
                self.count = done
                if not quiet:
                    print(f"resumed from {cp} at step {done}", flush=True)
        if done == 0:
            self._dump()
        ev = [e for e in self.events if int(round(e[0] / self.dt)) > done]
        t_wall0 = time.time()
        rebuilds = 0
        while done < n_steps:
            # steps until next boundary: pfreq, an event, or the end
            n_next = min(self.pfreq, n_steps - done)
            if ev:
                steps_to_ev = int(round(ev[0][0] / self.dt)) - done
                if steps_to_ev <= 0:
                    _, fn = ev.pop(0)
                    self.scene = fn(self.scene)
                    continue
                n_next = min(n_next, steps_to_ev)

            chunk_start = self.scene
            if n_next == self.pfreq:
                self.scene = multi(self.scene, self.dt)
            else:
                for _ in range(n_next):
                    self.scene = step(self.scene, self.dt)
            if self._overflowed():
                # A capacity sized from an earlier snapshot overflowed as
                # the particles spread (grid slots, lane width, domain
                # bounds, or spill stencil width).  PySPH's NNPS grows its
                # arrays dynamically; with XLA's static shapes growth is a
                # host-side rebuild from the chunk-start positions + a
                # re-jit, then the chunk is re-run from its start state
                # (overflow means pairs were DROPPED, so the chunk's
                # physics is invalid).  A repeat overflow from the same
                # snapshot additionally widens every slack factor 1.5x.
                rebuilds += 1
                if rebuilds > 8:
                    raise RuntimeError(
                        "neighbor capacity overflow persists after 8 grid "
                        "rebuilds — the scene is likely diverging")
                self.scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
                step = self.scheme.make_step(chunk_start)
                multi = make_multi_step(step, self.pfreq)
                self.scene = chunk_start
                if not quiet:
                    print(f"step {done}: capacity overflow — grid rebuilt "
                          f"(x{rebuilds}, boost "
                          f"{self.scheme.capacity_boost:.2f}); re-running "
                          f"chunk", flush=True)
                continue
            done += n_next
            self.count = done
            self.t = done * self.dt
            if done % self.pfreq == 0 or done == n_steps:
                rebuilds = 0
                self._dump()
                chunk_no = done // self.pfreq
                if chunk_no % self.checkpoint_every == 0 \
                        or done == n_steps:
                    ckpt_mod.save_checkpoint(
                        os.path.join(self.output_dir, "checkpoint.npz"),
                        self.scene, self.t, done)
                for cb in self.callbacks_post_chunk:
                    cb(self)
                el = time.time() - t_wall0
                self._steps_per_sec = done / max(el, 1e-9)
                if not quiet:
                    print(f"step {done}/{n_steps}  t={self.t:.6g}  "
                          f"{self._steps_per_sec:.1f} steps/s", flush=True)
        # drain pending snapshot writes (durability: every file in
        # output_files exists once solve() returns)
        if self._writer is not None:
            self._writer.flush()
        # ensure final state materialized
        import jax
        jax.block_until_ready(self.scene.fields["x"])
        return self.scene


class Application:
    """Subclass per case script, mirroring the reference's PySPH app
    surface: ``initialize / create_particles / create_scheme /
    configure_scheme / post_process / customize_output``."""

    def __init__(self, fname: Optional[str] = None):
        self.fname = fname or type(self).__name__.lower()
        self.solver: Optional[Solver] = None
        self.scene: Optional[Scene] = None
        self.scheme = None
        self.options: Optional[argparse.Namespace] = None
        self.output_dir = f"{self.fname}_output"
        self.events: List[Tuple[float, Callable]] = []
        self.initialize()

    # -- hooks ------------------------------------------------------------
    def initialize(self):
        pass

    def create_particles(self) -> Scene:
        raise NotImplementedError

    def create_scheme(self):
        raise NotImplementedError

    def configure_scheme(self):
        pass

    def add_user_options(self, group):
        pass

    def consume_user_options(self):
        pass

    def post_process(self, info_fname: Optional[str] = None):
        pass

    def customize_output(self):
        pass

    # -- plumbing ---------------------------------------------------------
    @property
    def info_filename(self) -> str:
        return os.path.join(self.output_dir, f"{self.fname}.info.json")

    @property
    def output_files(self) -> List[str]:
        if self.solver is not None and self.solver.output_files:
            return self.solver.output_files
        return out_mod.get_files(self.output_dir)

    def _parse(self, argv):
        p = argparse.ArgumentParser(prog=self.fname)
        p.add_argument("-d", "--output-dir", default=self.output_dir)
        p.add_argument("--tf", type=float, default=None)
        p.add_argument("--timestep", type=float, default=None, dest="dt")
        p.add_argument("--pfreq", type=int, default=None)
        p.add_argument("--max-steps", type=int, default=None)
        p.add_argument("--resume", action="store_true",
                       help="continue from the last checkpoint in the "
                            "output dir")
        p.add_argument("--quiet", action="store_true")
        p.add_argument("--openmp", action="store_true",
                       help="accepted for reference-CLI compatibility "
                            "(everything already runs on the accelerator)")
        g = p.add_argument_group("scheme options")
        self.add_user_options(g)
        self.scheme = self.create_scheme()
        self.scheme.add_user_options(g)
        self.options = p.parse_args(argv)
        self.output_dir = self.options.output_dir
        self.consume_user_options()
        self.scheme.consume_user_options(self.options)

    def add_event(self, t: float, fn: Callable):
        """Schedule a host-side scene edit at simulated time t (the
        reference's ``post_step`` pattern)."""
        self.events.append((t, fn))

    def run(self, argv: Optional[Sequence[str]] = None):
        self._parse(list(argv) if argv is not None else sys.argv[1:])
        self.scene = self.create_particles()
        self.configure_scheme()
        if self.options.dt:
            self.scheme.dt = self.options.dt
        if self.options.tf is not None:
            self.scheme.tf = self.options.tf
        if self.options.pfreq:
            self.scheme.pfreq = self.options.pfreq
        dt, tf = self.scheme.dt, self.scheme.tf
        if self.options.max_steps:
            tf = min(tf, self.options.max_steps * dt)
        self.solver = Solver(
            self.scheme, self.scene, dt=dt, tf=tf,
            pfreq=self.scheme.pfreq, output_dir=self.output_dir,
            events=self.events,
        )
        t0 = time.time()
        self.scene = self.solver.solve(quiet=self.options.quiet,
                                       resume=self.options.resume)
        elapsed = time.time() - t0
        os.makedirs(self.output_dir, exist_ok=True)
        out_mod.write_info(
            self.info_filename,
            fname=self.fname, completed=True, cpu_time=elapsed,
            dt=dt, tf=tf, n_particles=self.scene.n,
            steps_per_sec=self.solver._steps_per_sec,
            output_dir=self.output_dir,
            args=vars(self.options),
        )
        return self.scene

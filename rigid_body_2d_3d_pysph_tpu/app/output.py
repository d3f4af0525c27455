"""Snapshot output: npz writer / loader / iterator.

Replaces the reference's solver output stack (PySPH ``dump`` files +
``pysph.solver.utils.load/iter_output``, consumed at
``code/benchmark_1...py:135-150`` and ``code/stack_of_cylinders.py:457``).

One ``.npz`` per snapshot holds every per-particle output field for every
group (``<group>/<field>`` keys), the per-group body-state slices
(``xcm``, ``vcm``, ``R``, ``omega``, ``ang_mom``, ``total_mass``, ``nb``)
and solver data (``t``, ``dt``, ``count``).  ``iter_output`` yields
``(solver_data, group_namespace)`` pairs exactly like the reference's
post-processing loops expect.
"""

from __future__ import annotations

import glob
import json
import os
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_OUTPUT_FIELDS = (
    "x", "y", "z", "u", "v", "w", "fx", "fy", "fz", "m", "h", "rho", "p",
    "body_id", "dem_id", "is_boundary",
)

BODY_STATE_KEYS = ("xcm", "vcm", "R", "omega", "ang_mom", "total_mass",
                   "force", "torque", "izz")


def write_snapshot(path: str, scene, t: float, dt: float, count: int,
                   output_fields: Optional[Sequence[str]] = None) -> None:
    data: Dict[str, np.ndarray] = {
        "solver/t": np.float64(t),
        "solver/dt": np.float64(dt),
        "solver/count": np.int64(count),
    }
    fields = output_fields or DEFAULT_OUTPUT_FIELDS
    # ONE device->host transfer for everything the snapshot reads: a
    # per-field np.asarray costs a synchronising round trip each
    import jax

    want = {f for f in fields if f in scene}
    want |= {k for k in ("normal", "body_id") + BODY_STATE_KEYS
             if k in scene}
    host = jax.device_get({k: scene[k] for k in want})
    for g in scene.meta.groups:
        for f in fields:
            arr = host.get(f)
            if arr is not None and np.ndim(arr) >= 1 \
                    and arr.shape[0] == scene.n:
                data[f"{g.name}/{f}"] = arr[g.start:g.stop]
        if "normal" in host:
            data[f"{g.name}/normal"] = host["normal"][g.start:g.stop]
        if g.role == "rigid" and "xcm" in host:
            bid = host["body_id"][g.start:g.stop]
            if bid.size == 0 or bid.max() < 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(bid.min()), int(bid.max()) + 1
            for k in BODY_STATE_KEYS:
                if k in host:
                    data[f"{g.name}/body.{k}"] = host[k][lo:hi]
            data[f"{g.name}/body.nb"] = np.int64(hi - lo)
    np.savez(path, **data)


class AsyncSnapshotWriter:
    """Double-buffered background snapshot writer.

    ``write_snapshot`` costs one device->host transfer plus an npz
    write, serial with the step loop when done inline.  JAX
    arrays are immutable, so the Solver can hand the scene reference to
    a worker thread and keep stepping while the worker does the
    device_get + npz in the background (the transfer overlaps device
    compute).  ``max_pending`` bounds queued snapshots (backpressure —
    each holds a scene's device buffers alive).

    Exceptions raised by the worker re-raise on the next submit/flush.
    """

    def __init__(self, max_pending: int = 2):
        import queue
        import threading
        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                write_snapshot(*item)
            except BaseException as e:  # surfaced on submit/flush
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async snapshot write failed") from err

    def submit(self, path, scene, t, dt, count, output_fields=None):
        self._check()
        self._q.put((path, scene, t, dt, count, output_fields))

    def flush(self):
        self._q.join()
        self._check()

    def close(self):
        if self._thread.is_alive():
            self._q.join()
            self._q.put(None)
            self._thread.join()
        self._check()


class GroupSnapshot(SimpleNamespace):
    """Attribute view of one group in one snapshot; body-state arrays are
    exposed both shaped ([B,3]/[B,3,3]) and reference-flat (xcm as [3B],
    R as [9B]) so reference-style post-processing indexes keep working."""


def load(path: str):
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    sd = {k.split("/", 1)[1]: raw.pop(k) for k in list(raw)
          if k.startswith("solver/")}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in raw.items():
        gname, f = k.split("/", 1)
        groups.setdefault(gname, {})[f] = v
    out = {}
    for gname, fields in groups.items():
        ns = GroupSnapshot()
        for f, v in fields.items():
            if f.startswith("body."):
                key = f[len("body."):]
                setattr(ns, key if key != "nb" else "nb",
                        v if key != "nb" else np.array([int(v)]))
                if key in ("xcm", "vcm", "omega", "ang_mom", "force",
                           "torque", "R"):
                    setattr(ns, key, v.reshape(-1))  # reference-flat
                    setattr(ns, key + "_mat", v)
            else:
                setattr(ns, f, v)
        out[gname] = ns
    return sd, out


def get_files(output_dir: str) -> List[str]:
    files = glob.glob(os.path.join(output_dir, "snapshot_*.npz"))
    return sorted(files, key=lambda f: int(
        os.path.basename(f).split("_")[1].split(".")[0]))


def iter_output(files: Sequence[str], group: str):
    """Yield (solver_data, group_snapshot) per file — the reference's
    ``iter_output(files, 'body')`` pattern."""
    for f in files:
        sd, groups = load(f)
        yield sd, groups[group]


def write_info(path: str, **kw) -> None:
    with open(path, "w") as f:
        json.dump(kw, f, indent=2, default=str)

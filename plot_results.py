"""Post-processing figures from case outputs (automate.py's plotting role).

The reference collects matplotlib figures per case through automan
(``automate.py:488-528,835-858``).  This script renders the equivalent
validation plots from the ``results.npz`` files the cases produce:

  benchmark_1           total kinetic energy vs t; COM path
  benchmark_4           rebound trajectories per restitution
  stack_of_cylinders    COM x/L and y/L vs the digitized Zhang data
  sinking_box           box max-y (surface penetration depth) vs t

Usage: python plot_results.py [case ...]   (figures land in <case>_output/)
"""

from __future__ import annotations

import os
import sys

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _res(case):
    p = os.path.join(HERE, f"{case}_output", "results.npz")
    return np.load(p) if os.path.exists(p) else None


def plot_benchmark_1():
    r = _res("benchmark_1")
    if r is None:
        return
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.5))
    ax[0].plot(r["t"], r["total_energy"])
    ax[0].set_xlabel("t [s]")
    ax[0].set_ylabel("total KE [J]")
    ax[0].set_title("benchmark 1: energy conservation")
    ax[1].plot(r["x"], r["y"])
    ax[1].set_xlabel("x_cm")
    ax[1].set_ylabel("y_cm")
    ax[1].set_title("COM path")
    fig.tight_layout()
    fig.savefig(os.path.join(HERE, "benchmark_1_output",
                             "total_energy_vs_t.png"), dpi=150)


def plot_stack_of_cylinders():
    r = _res("stack_of_cylinders")
    if r is None:
        return
    for comp, sim, zt, zv in (("x", "x_com", "zhang_t_x", "zhang_x"),
                              ("y", "y_com", "zhang_t_y", "zhang_y")):
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(r[zt], r[zv], "s--", label="Experiment (Zhang)")
        ax.plot(r["t"], r[sim], "-", label="Simulated")
        ax.set_xlabel("time [s]")
        ax.set_ylabel(f"{comp}/L")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(HERE, "stack_of_cylinders_output",
                                 f"{comp}com.png"), dpi=150)


def plot_sinking_box():
    r = _res("sinking_box")
    if r is None:
        return
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(r["t"], r["max_y"], label="box top")
    ax.plot(r["t"], r["y_com"], label="box COM")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("y [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(HERE, "sinking_box_output", "max_z.png"),
                dpi=150)


def plot_benchmark_4():
    from rigid_body_2d_3d_pysph_tpu.app import output as out_mod
    fig, ax = plt.subplots(figsize=(5, 3.5))
    found = False
    for en in ("1.0", "0.5"):
        d = os.path.join(HERE, f"benchmark_4_en_{en}_output")
        files = out_mod.get_files(d)
        if not files:
            continue
        found = True
        t, y = [], []
        for sd, body in out_mod.iter_output(files, "body"):
            t.append(float(sd["t"]))
            y.append(body.xcm_mat[:, 1].mean())
        ax.plot(t, y, label=f"e = {en}")
    if not found:
        return
    ax.set_xlabel("time [s]")
    ax.set_ylabel("mean body y_cm [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(HERE, "benchmark_4_en_1.0_output",
                             "rebound.png"), dpi=150)


PLOTS = {
    "benchmark_1": plot_benchmark_1,
    "benchmark_4": plot_benchmark_4,
    "stack_of_cylinders": plot_stack_of_cylinders,
    "sinking_box": plot_sinking_box,
}

if __name__ == "__main__":
    names = sys.argv[1:] or list(PLOTS)
    for n in names:
        PLOTS[n]()
        print(f"plotted {n}")

"""Trajectory / field visualization — the tf_pub + RViz replacement.

The reference renders APF attractive/repulsive arrows and TF frames into
RViz (reference dogbot_controller/src/client/tf_pub.cpp:179-336).  Here the
same observability is a matplotlib figure: the terrain mu-map as an image,
the CoM path, per-cycle foot positions, and APF field arrows — written to a
PNG (headless-safe).

The port's copy of apf_quadruped_tpu/runtime/viz.py (tests/
test_torch_hygiene.py holds it to the original): it takes numpy arrays,
which the `run` command makes of the port's tensors.
"""

from __future__ import annotations

import numpy as np


def plot_run(path: str, mu_map, extent: float, com_traj,
             target_xy=None, feet=None, f_att=None, f_rep=None,
             footholds=None,
             title: str = "apf_quadruped_tpu_torch run") -> str:
    """Render one scenario run.

    mu_map: (res, res); com_traj: (T, >=2); feet: optional (4, 2);
    f_att/f_rep: optional (4, 2) field vectors at `feet`; footholds:
    optional (.., 2) CHOSEN step targets (foothold.optimize output) —
    plotted so the mu-aware selection is visible against the patch map.
    Returns the written path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mu = np.asarray(mu_map)
    com = np.asarray(com_traj)
    fig, ax = plt.subplots(figsize=(7, 7))
    im = ax.imshow(mu, origin="lower", extent=[-extent, extent, -extent,
                                               extent],
                   cmap="YlGn", vmin=0.0, vmax=1.0, alpha=0.8)
    fig.colorbar(im, ax=ax, label="friction coefficient mu", shrink=0.8)
    ax.plot(com[:, 0], com[:, 1], "b.-", lw=1.5, ms=3, label="CoM path")
    ax.plot(com[0, 0], com[0, 1], "ks", ms=8, label="start")
    if target_xy is not None:
        t = np.asarray(target_xy)
        ax.plot(t[0], t[1], "r*", ms=16, label="target")
    if feet is not None:
        f = np.asarray(feet)
        ax.plot(f[:, 0], f[:, 1], "ko", ms=5, label="feet")
        for name, vec, color in (("attractive", f_att, "tab:blue"),
                                 ("repulsive", f_rep, "tab:red")):
            if vec is None:
                continue
            v = np.asarray(vec)
            ax.quiver(f[:, 0], f[:, 1], v[:, 0], v[:, 1], color=color,
                      angles="xy", scale_units="xy", scale=1.0,
                      width=0.004, label=f"{name} field")
    if footholds is not None:
        fh = np.asarray(footholds).reshape(-1, 2)
        ax.plot(fh[:, 0], fh[:, 1], "x", color="tab:purple", ms=6,
                label="chosen footholds")
    lim = min(extent, max(2.5, np.abs(com[:, :2]).max() + 1.0))
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-1.0, max(2.0, lim))
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m] (forward)")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_metrics(path: str, metrics, title: str = "per-cycle metrics") -> str:
    """Plot CycleMetrics time series (rob index, tracking error, QP health)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = {k: np.asarray(v) for k, v in metrics._asdict().items()}
    t = np.arange(len(m["rob_mean"]))
    fig, axes = plt.subplots(2, 2, figsize=(10, 6))
    axes[0, 0].plot(t, m["rob_mean"], "o-")
    axes[0, 0].axhline(0.34, color="r", ls="--", label="crawl threshold")
    axes[0, 0].set_title("robustness index (mean)")
    axes[0, 0].legend(fontsize=8)
    axes[0, 1].plot(t, m["track_err"], "o-", label="track err [m]")
    if "foot_mu" in m:
        ax2 = axes[0, 1].twinx()
        ax2.plot(t, m["foot_mu"], "^-", color="tab:green", alpha=0.6)
        ax2.set_ylabel("foothold mu", color="tab:green")
        ax2.set_ylim(0, 1)
    axes[0, 1].set_title("CoM tracking error / foothold mu")
    axes[1, 0].plot(t, m["qp_converged"], "o-", label="WBC conv frac")
    axes[1, 0].plot(t, m["slip_ticks"], "s-", label="slip frac")
    axes[1, 0].set_ylim(-0.05, 1.05)
    axes[1, 0].legend(fontsize=8)
    axes[1, 0].set_title("solver / contact health")
    axes[1, 1].plot(t, m["tau_max"], "o-", label="peak |tau| [Nm]")
    axes[1, 1].axhline(60.0, color="r", ls="--")
    if "wrench_peak" in m:
        # observer disturbance estimate (the estimation_ee topic's role)
        ax3 = axes[1, 1].twinx()
        ax3.plot(t, m["wrench_peak"], "v-", color="tab:red", alpha=0.6)
        ax3.set_ylabel("peak |w_est| [N]", color="tab:red")
    axes[1, 1].set_title("peak |tau| / est. external force")
    for ax in axes.flat:
        ax.set_xlabel("cycle")
        ax.grid(alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path

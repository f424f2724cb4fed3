"""Training visualization — offline-first (accelerator hosts have no display).

Keeps the reference's Visualizer interface (``reference:
SCFGP/Visualizer.py:16-25``: construct with a figure, assign ``.model``, call
``train_with_plot()`` to get a per-iteration callback) so experiment scripts
port over unchanged, but instead of a live GUI animation it records history
and renders final plots to files:

  * 1-D posterior band plot for D == 1 models (``Visualizer.py:27-49``), with
    the same 9-level shaded error bands,
  * cost + chosen-eval vs training time for D > 1 (``Visualizer.py:51-82``).

Use ``save(path)`` after training, or pass ``snapshot_every`` to write
intermediate frames (the offline analog of the live animation).
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, imported on first
    use so that ``import scfgp`` does not need matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class Visualizer:

    def __init__(self, fig=None, eval="NMSE", plot_limit=80,
                 snapshot_every=0, snapshot_path="training_%04d.png",
                 record_every=0):
        self.fig = fig or _pyplot().figure(figsize=(8, 6), facecolor="white")
        self.eval = eval.upper()
        self.plot_limit = plot_limit
        self.snapshot_every = snapshot_every
        self.snapshot_path = snapshot_path
        self.record_every = record_every
        self.frames = []  # in-memory RGB frames when record_every > 0
        self.model = None

    def train_with_plot(self):
        """Return the per-iteration callback the training loop invokes."""
        def animate(i):
            if self.snapshot_every and i % self.snapshot_every == 0:
                self.render()
                self.fig.savefig(self.snapshot_path % i)
            if self.record_every and i % self.record_every == 0:
                self._grab_frame()
        return animate

    def _grab_frame(self):
        self.render()
        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())
        self.frames.append(buf[..., :3].copy())

    def save_animation(self, path: str, duration_ms: int = 150):
        """Write recorded frames as a GIF — the offline analog of the
        reference's committed live-training animation
        (``reference: experiments/plot_training.gif``; the live loop is
        ``Visualizer.py:27-49``).  Requires ``record_every > 0`` during
        training (or manual ``_grab_frame`` calls)."""
        if not self.frames:
            raise RuntimeError("no frames recorded: construct the "
                               "Visualizer with record_every > 0")
        from PIL import Image
        imgs = [Image.fromarray(f) for f in self.frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=duration_ms, loop=0)

    # -- rendering ------------------------------------------------------------

    def render(self):
        self.fig.clf()
        if self.model.D == 1:
            self._render_1d()
        else:
            self._render_evals()

    def save(self, path: str):
        self.render()
        self.fig.savefig(path, dpi=120, bbox_inches="tight")

    def _render_1d(self):
        """Posterior band plot over the scaled input range (Visualizer.py:27-49)."""
        m = self.model
        self.fig.suptitle(m.NAME, fontsize=15)
        ax = self.fig.add_subplot(111)
        pts = 300
        errors = [0.25, 0.39, 0.52, 0.67, 0.84, 1.04, 1.28, 1.64, 2.2]
        Xs = np.linspace(-0.1, 1.1, pts)[:, None]
        mu, std = m._predict_on_scaled(Xs)
        for er in errors:
            ax.fill_between(Xs[:, 0], mu - er * std, mu + er * std,
                            alpha=((3 - er) / 5.5) ** 1.7, facecolor="blue",
                            linewidth=0.0)
        ax.plot(Xs[:, 0], mu, alpha=0.8, c="black")
        X = np.asarray(m.X)
        y = np.asarray(m.y).ravel()
        ax.errorbar(X[:, 0], y, fmt="r.", markersize=5, alpha=0.6)
        yrng = y.max() - y.min()
        ax.set_ylim([y.min() - 0.5 * yrng, y.max() + 0.5 * yrng])
        ax.set_xlim([-0.1, 1.1])

    def _render_evals(self):
        """Cost + eval metric vs time (Visualizer.py:51-82), from history."""
        m = self.model
        self.fig.suptitle(m.NAME, fontsize=15)
        ax1 = self.fig.add_subplot(211)
        ax2 = self.fig.add_subplot(212)
        t = m.evals["TIME(s)"][1][-self.plot_limit:]
        cost = m.evals["COST"][1][-self.plot_limit:]
        ax1.plot(t, cost, color="r", linewidth=2.0, label="COST")
        ax1.legend(loc="upper center", bbox_to_anchor=(0.5, 1.05), ncol=1,
                   fancybox=True)
        ev = m.evals[self.eval][1]
        if ev:
            n = min(len(ev), len(t))
            ax2.plot(t[-n:], ev[-n:], color="b", linewidth=2.0,
                     label=self.eval)
            ax2.legend(loc="upper center", bbox_to_anchor=(0.5, 1.05), ncol=1,
                       fancybox=True)
        ax2.set_xlabel("TIME(s)", fontsize=13)

"""Visualization: dataset browser, realtime capture view, dataset plot.

Port of radarml_tpu/viz/plots.py (numpy and matplotlib; the arena is the
port's). matplotlib is imported inside the functions that draw, so
importing this module needs none.

Re-design of the reference's matplotlib tooling — the keypress-driven
per-sample 3-projection browser (visualize.py:23-166), the realtime
ground-truth capture animation with target/centroid markers
(ground_truth_samples.py:160-311), and the per-class feature-matrix
plot (train.py:276-291). Geometry is arena-parameterized instead of
hard-coded module constants: the polar position maps are generated
from any Arena, so higher-resolution arenas visualize unchanged.

All figures build headless (Agg); `show()`/animation writers are only
touched by the CLI apps.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena

__all__ = [
    "gen_pos_map",
    "DatasetBrowser",
    "CaptureView",
    "plot_dataset",
]


def _pol2cart_deg(a_deg, r):
    a = np.deg2rad(a_deg)
    return r * np.sin(a), r * np.cos(a)


def gen_pos_map(arena: Arena = DEFAULT_ARENA) -> Tuple[np.ndarray, np.ndarray]:
    """(pmap_yz, pmap_xz) scatter maps [[coords], [z], [dot size]].

    The XZ map spans phi × r and the YZ map theta × r, mirroring the
    reference's gen_pos_map (visualize.py:28-42) with the arena's own
    bounds/resolutions.
    """
    arr_r = list(np.arange(arena.r_min, arena.r_max, arena.r_res)) + [arena.r_max]
    arr_t = list(
        np.arange(arena.theta_min, arena.theta_max, arena.theta_res)
    ) + [arena.theta_max]
    arr_p = list(
        np.arange(arena.phi_min, arena.phi_max, arena.phi_res)
    ) + [arena.phi_max]
    pmap_xz = np.array(
        [list(_pol2cart_deg(p, ra)) + [ra * 0.75] for ra in arr_r for p in arr_p]
    ).T
    pmap_yz = np.array(
        [list(_pol2cart_deg(t, ra)) + [ra * 0.75] for ra in arr_r for t in arr_t]
    ).T
    return pmap_yz, pmap_xz


def _init_axis(ax, title, xlabel, ylabel):
    from matplotlib.cm import ScalarMappable

    ax.set_title(title)
    ax.set_facecolor(ScalarMappable(cmap="coolwarm").to_rgba(0))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)


@dataclasses.dataclass
class _ThreePane:
    """Shared 3-pane scaffold: XZ/YZ polar scatters + XY image."""

    arena: Arena
    horizontal: bool = True

    def build(self):
        import matplotlib.pyplot as plt
        from matplotlib.cm import ScalarMappable

        self.fig = plt.figure(figsize=(9, 7))
        gs = self.fig.add_gridspec(2, 2)
        self.ax_xz = self.fig.add_subplot(gs[0, 0])
        self.ax_yz = self.fig.add_subplot(gs[0, 1])
        self.ax_xy = self.fig.add_subplot(gs[1, :])
        pmap_yz, pmap_xz = gen_pos_map(self.arena)
        self.pmap_yz, self.pmap_xz = pmap_yz, pmap_xz

        _init_axis(self.ax_xz, "X-Z Plane", "X (cm)", "Z (cm)")
        sm = ScalarMappable(cmap="coolwarm")
        zeros = np.zeros(pmap_xz.shape[1])
        self.pts_xz = self.ax_xz.scatter(
            pmap_xz[0], pmap_xz[1], s=pmap_xz[2],
            c=sm.to_rgba(zeros), cmap="coolwarm", zorder=1,
        )
        _init_axis(self.ax_yz, "Y-Z Plane", "Y (cm)", "Z (cm)")
        zeros = np.zeros(pmap_yz.shape[1])
        self.pts_yz = self.ax_yz.scatter(
            pmap_yz[0], pmap_yz[1], s=pmap_yz[2],
            c=sm.to_rgba(zeros), cmap="coolwarm", zorder=1,
        )
        _init_axis(self.ax_xy, "X-Y Plane", "X (cm)", "Y (cm)")
        self.xmin, self.xmax = (
            int(pmap_xz[0].min()), int(pmap_xz[0].max())
        )
        self.ymin, self.ymax = (
            int(pmap_yz[0].min()), int(pmap_yz[0].max())
        )
        self.zmin, self.zmax = (
            int(pmap_yz[1].min()), int(pmap_yz[1].max())
        )
        self.ax_xy.set_xlim(self.xmax, self.xmin)
        self.ax_xy.set_ylim(self.ymax, self.ymin)
        img0 = np.zeros(
            (self.arena.size_y, self.arena.size_x)
            if self.horizontal
            else (self.arena.size_x, self.arena.size_y)
        )
        self.img_xy = self.ax_xy.imshow(
            sm.to_rgba(img0), cmap="coolwarm",
            extent=[self.xmin, self.xmax, self.ymin, self.ymax], zorder=1,
        )
        return self.fig

    def set_sample(self, xz: np.ndarray, yz: np.ndarray, xy: np.ndarray):
        from matplotlib.cm import ScalarMappable

        sm = ScalarMappable(cmap="coolwarm")
        self.pts_xz.set_color(sm.to_rgba(np.asarray(xz).T.flatten()))
        sm = ScalarMappable(cmap="coolwarm")
        self.pts_yz.set_color(sm.to_rgba(np.asarray(yz).T.flatten()))
        if self.horizontal:
            xy = np.rot90(xy)
        sm = ScalarMappable(cmap="coolwarm")
        self.img_xy.set_data(sm.to_rgba(xy))


class DatasetBrowser:
    """Keypress-driven sample viewer: n=next, b=back, escape=close
    (reference visualize.py)."""

    def __init__(
        self,
        samples: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        labels: Sequence[str],
        arena: Arena = DEFAULT_ARENA,
        horizontal: bool = True,
    ):
        if not samples:
            raise ValueError("no samples to browse")
        self.samples, self.labels = samples, labels
        self.idx = 0
        self.pane = _ThreePane(arena, horizontal)
        self.fig = self.pane.build()
        self.title = self.fig.suptitle("")
        self._refresh()
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)

    def _refresh(self):
        xz, yz, xy = self.samples[self.idx]
        self.title.set_text(
            f'Target Return Signal. Label "{self.labels[self.idx]}", '
            f"Sample {self.idx}."
        )
        self.pane.set_sample(xz, yz, xy)

    def on_key(self, event):
        import matplotlib.pyplot as plt

        if event.key == "n":
            self.idx = min(self.idx + 1, len(self.samples) - 1)
        elif event.key == "b":
            self.idx = max(self.idx - 1, 0)
        elif event.key == "escape":
            plt.close(self.fig)
            return
        self._refresh()
        plt.draw()

    def show(self):
        import matplotlib.pyplot as plt

        plt.show()


class CaptureView:
    """Realtime capture animation over a CapturedSample stream
    (reference plot_and_capture_data's FuncAnimation path)."""

    def __init__(self, arena: Arena = DEFAULT_ARENA, horizontal: bool = True):
        self.pane = _ThreePane(arena, horizontal)
        self.fig = self.pane.build()
        self.markers = {}
        for name, ax in (
            ("xz", self.pane.ax_xz), ("yz", self.pane.ax_yz),
            ("xy", self.pane.ax_xy),
        ):
            (tp,) = ax.plot([0], [0], "ro", zorder=2)
            ta = ax.annotate("target", xy=(0, 0), color="red", zorder=2)
            (cp,) = ax.plot([0], [0], "go", zorder=3)
            ca = ax.annotate("", xy=(0, 0), color="green", zorder=3)
            self.markers[name] = (tp, ta, cp, ca)

    def update(self, sample) -> tuple:
        """Apply one CapturedSample; returns changed artists."""
        xz, yz, xy = sample.projections
        tx, ty, tz = sample.target_position
        cx, cy = sample.centroid_position
        m = self.markers
        m["xz"][0].set_data([tx], [tz]); m["xz"][1].set_position((tx, tz))
        m["yz"][0].set_data([ty], [tz]); m["yz"][1].set_position((ty, tz))
        m["xy"][0].set_data([tx], [ty]); m["xy"][1].set_position((tx, ty))
        for k, (px, py) in (("xz", (cx, tz)), ("yz", (cy, tz)), ("xy", (cx, cy))):
            m[k][2].set_data([px], [py])
            m[k][3].set_text(sample.label)
            m[k][3].set_position((px, py))
        # Scale the xy image extent with target depth (reference
        # ground_truth_samples.py:237-239).
        p = self.pane
        scale = tz / max(p.zmax - p.zmin, 1)
        p.img_xy.set_extent(
            [v * scale for v in (p.xmin, p.xmax, p.ymin, p.ymax)]
        )
        p.set_sample(xz, yz, xy)
        artists = [p.pts_xz, p.pts_yz, p.img_xy]
        for k in m:
            artists.extend(m[k])
        return tuple(artists)

    def animate(self, frames: Iterable, interval_ms: int = 100):
        from matplotlib import animation

        return animation.FuncAnimation(
            self.fig, self.update, frames=frames,
            repeat=False, interval=interval_ms, blit=True,
        )


def plot_dataset(
    features: np.ndarray, labels: np.ndarray, class_names: Sequence[str]
):
    """Per-class matshow of the feature matrix (train.py:276-291)."""
    import matplotlib.pyplot as plt

    figs = []
    for c, name in enumerate(class_names):
        rows = features[np.asarray(labels) == c]
        fig, ax = plt.subplots(figsize=(8, 3))
        if rows.size:
            ax.matshow(rows, aspect="auto")
        ax.set_title(f'Feature matrix for class "{name}" ({len(rows)} samples)')
        ax.set_xlabel("feature index")
        ax.set_ylabel("sample")
        figs.append(fig)
    return figs

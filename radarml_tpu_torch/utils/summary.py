"""Model architecture/parameter summaries.

Port of radarml_tpu/utils/summary.py. The reference dumps Keras
`plot_model` PNGs next to its checkpoints (reference dnn.py:426-427,
sgan.py:750-765). Here, as in the JAX package, a parameter tree in flax
naming (models/cnn.cnn_params_to_numpy, models/sgan.sgan_params_to_numpy)
renders as a text table of every leaf with shape, dtype and count, plus
totals, and optionally as a PNG. Leaves are visited in sorted key order,
as jax.tree_util flattens a dict, so the text equals the JAX package's
for the same tree. matplotlib is imported only when a PNG is drawn.
"""

from __future__ import annotations

import logging
from typing import Any, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["model_summary", "write_model_summary", "plot_model_png", "plot_model_pngs"]


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], path + (str(k),))
        return out
    return [(path, tree)]


def _dtype(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    return str(dtype).replace("torch.", "")


def model_summary(params: Any, title: str = "model") -> str:
    """Render a nested dict of arrays or tensors as an aligned text table."""
    rows = []
    total = 0
    for path, leaf in _leaves(params):
        shape = tuple(getattr(leaf, "shape", ()))
        count = int(np.prod(shape)) if shape else 1
        total += count
        rows.append(("/".join(path), shape, _dtype(leaf), count))

    width = max([len(r[0]) for r in rows] + [len("parameter")])
    lines = [
        f"# {title}",
        "",
        f"{'parameter'.ljust(width)}  {'shape'.ljust(18)}  {'dtype'.ljust(10)}  params",
        "-" * (width + 40),
    ]
    for name, shape, dtype, count in rows:
        lines.append(
            f"{name.ljust(width)}  {str(shape).ljust(18)}  "
            f"{dtype.ljust(10)}  {count:,}"
        )
    lines += [
        "-" * (width + 40),
        f"total parameters: {total:,} "
        f"({total * 4 / 1024:,.1f} KiB at f32)",
        "",
    ]
    return "\n".join(lines)


def write_model_summary(path: str, params: Any, title: str = "model") -> str:
    """Write `model_summary` to `path`; returns the rendered text."""
    text = model_summary(params, title)
    with open(path, "w") as fp:
        fp.write(text)
    return text


def plot_model_png(path: str, params: Any, title: str = "model") -> str:
    """Graphical architecture dump: the Keras `plot_model` analog.

    One box per top-level module (stacked in declaration order, which for
    these sequential networks is the data path), each listing its
    parameter leaves with shapes, plus a totals footer. matplotlib/Agg,
    imported here; raises ImportError where it is not installed.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: dict = {}
    total = 0
    for keys, leaf in _leaves(params):
        head = keys[0] if keys else "params"
        tail = "/".join(keys[1:]) or keys[0]
        shape = tuple(getattr(leaf, "shape", ()))
        count = int(np.prod(shape)) if shape else 1
        total += count
        groups.setdefault(head, []).append((tail, shape, count))

    n = len(groups)
    row_h = 0.9
    fig_h = max(2.5, 1.2 + n * row_h + 0.6)
    fig, ax = plt.subplots(figsize=(7.5, fig_h))
    ax.set_axis_off()
    ax.set_xlim(0, 1)
    ax.set_ylim(0, n * row_h + 1.0)
    ax.text(0.5, n * row_h + 0.55, title, ha="center", va="center",
            fontsize=11, fontweight="bold")

    for i, (name, leaves) in enumerate(groups.items()):
        top = (n - i) * row_h
        g_count = sum(c for _, _, c in leaves)
        body = "   ".join(f"{t}: {s}" for t, s, _ in leaves[:4]) + (
            "   …" if len(leaves) > 4 else "")
        ax.add_patch(plt.Rectangle(
            (0.06, top - 0.72), 0.88, 0.62,
            facecolor="#eef3fb", edgecolor="#35507a", linewidth=1.2,
        ))
        ax.text(0.09, top - 0.28, name, fontsize=10, fontweight="bold", va="center")
        ax.text(0.92, top - 0.28, f"{g_count:,} params", fontsize=8,
                va="center", ha="right", color="#555555")
        ax.text(0.09, top - 0.56, body, fontsize=7.5, va="center",
                family="monospace", color="#333333")
        if i < n - 1:
            ax.annotate("", xy=(0.5, top - row_h - 0.10), xytext=(0.5, top - 0.72),
                        arrowprops=dict(arrowstyle="->", color="#35507a", lw=1.2))

    ax.text(0.5, 0.12, f"total parameters: {total:,}", ha="center", fontsize=9,
            color="#333333")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_model_pngs(figures: Sequence[Tuple[str, Any, str]]) -> int:
    """Draw each (path, params, title) with plot_model_png where matplotlib
    imports; where it does not, log that the figures were skipped and draw
    none. Returns the number drawn."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib is not installed: %d model figure(s) skipped",
                       len(figures))
        return 0
    for path, params, title in figures:
        plot_model_png(path, params, title)
    return len(figures)

"""The port's visualization builds and updates headless (Agg): the four
cases of tests/test_viz.py re-run on radarml_tpu_torch.viz, the position
maps against the JAX package's (numpy float64 in both, on the same
arena: equal exactly), and the visualize app's PNG render."""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from radarml_tpu.core.arena import Arena as JArena  # noqa: E402
from radarml_tpu.viz import gen_pos_map as jgen_pos_map  # noqa: E402
from radarml_tpu_torch.core.arena import Arena  # noqa: E402
from radarml_tpu_torch.fusion import CapturedSample  # noqa: E402
from radarml_tpu_torch.viz import (  # noqa: E402
    CaptureView,
    DatasetBrowser,
    gen_pos_map,
    plot_dataset,
)

ARENA = Arena()


def test_gen_pos_map_shapes():
    pmap_yz, pmap_xz = gen_pos_map(ARENA)
    # theta cells x r cells and phi cells x r cells
    assert pmap_yz.shape[0] == 3 and pmap_xz.shape[0] == 3
    assert pmap_xz.shape[1] == ARENA.size_y * ARENA.size_z
    assert pmap_yz.shape[1] == ARENA.size_x * ARENA.size_z
    # dot sizes scale with range
    assert pmap_yz[2].max() == pytest.approx(ARENA.r_max * 0.75)
    for got, want in zip((pmap_yz, pmap_xz), jgen_pos_map(JArena())):
        np.testing.assert_array_equal(got, want)


def _samples(n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        out.append(
            (
                rng.random(ARENA.xz_shape) * 255,
                rng.random(ARENA.yz_shape) * 255,
                rng.random(ARENA.xy_shape) * 255,
            )
        )
    return out


def test_dataset_browser_navigation():
    samples = _samples(3)
    labels = ["person", "dog", "cat"]
    b = DatasetBrowser(samples, labels, ARENA)
    assert 'Label "person"' in b.title.get_text()

    class K:
        def __init__(self, key):
            self.key = key

    b.on_key(K("n"))
    assert b.idx == 1 and 'Label "dog"' in b.title.get_text()
    b.on_key(K("b"))
    assert b.idx == 0
    b.on_key(K("b"))
    assert b.idx == 0  # clamped
    for _ in range(5):
        b.on_key(K("n"))
    assert b.idx == 2  # clamped at end
    b.on_key(K("escape"))


def test_capture_view_update():
    view = CaptureView(ARENA)
    s = _samples(1)[0]
    sample = CapturedSample(
        projections=s, label="dog",
        target_position=(10.0, -5.0, 150.0),
        centroid_position=(11.0, -4.0),
        score=0.9, distance_cm=2.0,
    )
    artists = view.update(sample)
    assert len(artists) >= 3
    assert view.markers["xz"][3].get_text() == "dog"


def test_plot_dataset_figures():
    rng = np.random.default_rng(0)
    X = rng.random((10, 50))
    y = np.array([0] * 6 + [1] * 4)
    figs = plot_dataset(X, y, ["person", "dog"])
    assert len(figs) == 2


def test_visualize_app_renders_a_png(tmp_path):
    from radarml_tpu_torch.apps import visualize
    from radarml_tpu_torch.data.store import save_dataset

    path = str(tmp_path / "ds.pickle")
    save_dataset(path, _samples(2), ["person", "dog"])
    png = tmp_path / "s.png"
    browser = visualize.main(["--dataset", path, "--out_png", str(png), "--index", "1"])
    assert browser.idx == 1 and png.read_bytes()[:4] == b"\x89PNG"

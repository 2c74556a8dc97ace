"""The golden asset radarml_tpu_torch/assets/golden_neural.npz: the JAX
package's neural families at full width on the CPU, for `chip_smoke.py`
phase 13 to hold the card to without importing JAX.

The asset holds seeds and JAX outputs, never weights. Both sides make the
weights from the seeds with numpy in the flax trees' shapes
(models/cnn.cnn_init_tree, models/sgan.sgan_init_trees) and make the
inputs from the seeds too (chip_smoke.golden_neural_inputs). It keeps:

- the MultiViewCNN's logits (80×80, 3 classes) on 16 views;
- the SGAN discriminator's (128×128) train-mode logits on 8 views, its
  BatchNorm statistics after that call, its pooled precise-BN statistics
  over the same views and its eval-mode logits under them on 8 others;
- the generator's (n_upsamples 4) eval-mode outputs on 2 latents, every
  4th pixel;
- each family's RadarPredictor over 64 synthetic scans (1 or 2 slots),
  the SGAN classifier under the pooled statistics.

Bars (chip_smoke.golden_neural_check): network outputs within 1e-4 of
max|golden|, statistics within 1e-4·(1 + |golden|), probabilities within
1e-4, decisions equal where the golden top-2 margin exceeds 1e-3. They
are ten times the CPU tests' bars: on the card the convolutions run
cuDNN's float32 algorithms (TF32 off), whose summation order differs from
XLA's on the CPU. The port on the CPU measured ≤ 3.6% of each bar
(64 scans), and the CPU test asks ≤ 10%.

Regenerate with:  JAX_PLATFORMS=cpu python tests/test_torch_neural_golden.py
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA as JAX_ARENA
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.models.cnn import MultiViewCNN as JaxCNN
from radarml_tpu.models.sgan import Discriminator as JaxDisc
from radarml_tpu.models.sgan import Generator as JaxGen
from radarml_tpu.train import sgan_trainer as jst
from radarml_tpu_torch.models.cnn import cnn_init_tree
from radarml_tpu_torch.models.sgan import sgan_init_trees, sgan_params_from_numpy

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "radarml_tpu_torch" / "assets" / "golden_neural.npz"
SEEDS = {"input_seed": 20261017, "scan_seed": 1234, "cnn_seed": 7, "sgan_seed": 11}
N_CHECK_SCANS = 8  # scans re-run in the CPU tests (the asset has 64)

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def split(x):
    return tuple(x[..., i:i + 1] for i in range(3))


def jax_record(g, n_scans):
    """The JAX package's side of the golden run (golden_neural_record's
    twin), on the CPU."""
    inp = CS.golden_neural_inputs(g)
    out = {}
    tree = cnn_init_tree(3, (80, 80), seed=int(g["cnn_seed"]))
    out["cnn_logits"] = JaxCNN(n_classes=3).apply({"params": tree}, inp["x_cnn"], train=False)
    (gp, gs), (dp, ds) = sgan_init_trees(3, (128, 128), seed=int(g["sgan_seed"]))
    jd = JaxDisc(n_classes=3, dropout_rate=0.0)
    out["disc_train"], mut = jd.apply({"params": dp, "batch_stats": ds}, split(inp["x_disc"]),
                                      train=True, mutable=["batch_stats"])
    out["disc_train_stats"] = CS.flat_stats(sgan_params_from_numpy({}, mut["batch_stats"]))
    pooled = jax.tree.map(np.asarray, jst._recal_fn(jd)(dp, ds, inp["x_disc"][None]))
    out["disc_pooled_stats"] = CS.flat_stats(sgan_params_from_numpy({}, pooled))
    out["disc_eval"] = jd.apply({"params": dp, "batch_stats": pooled}, split(inp["x_eval"]),
                                train=False)
    fakes = JaxGen(n_upsamples=4).apply({"params": gp, "batch_stats": gs}, inp["z"],
                                        train=False)
    out["gen_eval"] = np.concatenate([np.asarray(f) for f in fakes], -1)[:, ::4, ::4]

    def cnn_apply(views):
        return JaxCNN(n_classes=3).apply({"params": tree}, views, train=False)

    def sgan_apply(views):
        return jd.apply({"params": dp, "batch_stats": pooled}, split(views), train=False)

    for fam, apply, rescale in (("cnn", cnn_apply, (80, 80)), ("sgan", sgan_apply, (128, 128))):
        model = jpipe.NeuralClassifier(apply=apply, rescale=rescale, n_classes=3)
        pred, _, proba = jpipe.RadarPredictor(train_arena=JAX_ARENA, scan_arena=JAX_ARENA,
                                              model=model, min_proba=0.0)(
            inp["cubes"][:n_scans], inp["xyz"][:n_scans], inp["valid"][:n_scans])
        out[f"{fam}_pred"], out[f"{fam}_proba"] = pred, proba
    return {k: np.asarray(v) for k, v in out.items()}


def generate() -> dict:
    out = {k: np.int64(v) for k, v in SEEDS.items()}
    out.update(jax_record(out, CS.N_GOLD_SCANS))
    return out


def load() -> dict:
    with np.load(ASSET) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def golden():
    return load()


def test_asset_is_small_and_consistent(golden):
    assert ASSET.stat().st_size < 1024 * 1024
    assert {k: int(golden[k]) for k in SEEDS} == SEEDS
    assert golden["cnn_logits"].shape == (16, 3)
    assert golden["disc_train"].shape == golden["disc_eval"].shape == (8, 3)
    assert golden["gen_eval"].shape == (2, 32, 32, 3)
    for fam in ("cnn", "sgan"):
        assert golden[f"{fam}_proba"].shape == (CS.N_GOLD_SCANS, 2, 3)
    # no weights: the largest array is the generator's subsampled output
    assert max(a.size for a in golden.values()) <= 2 * 32 * 32 * 3
    measured = CS.golden_neural_check(golden, golden)  # the JAX run meets its bars
    assert measured["cnn_decided"] > 32 and measured["sgan_decided"] > 32


def test_asset_matches_fresh_jax_run(golden):
    """The JAX package, run again from the asset's seeds, gives the asset's
    outputs (its first scans for the predictors)."""
    fresh = jax_record(golden, N_CHECK_SCANS)
    for k, v in fresh.items():
        want = golden[k][:N_CHECK_SCANS] if k.endswith(("_pred", "_proba")) else golden[k]
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


def test_port_meets_the_golden_bars_on_the_cpu(golden):
    """chip_smoke's phase-13 golden check, with the port on the CPU."""
    got = CS.golden_neural_record(torch.device("cpu"), golden, n_scans=N_CHECK_SCANS)
    measured = CS.golden_neural_check(got, golden)
    for k, v in measured.items():
        if not k.endswith("_decided"):
            assert v <= 0.1, (k, v)  # the port on the CPU sits far inside each bar


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    record = generate()
    np.savez_compressed(ASSET, **record)
    print(f"wrote {ASSET} ({ASSET.stat().st_size} bytes)", file=sys.stderr)

"""Phase 12's golden run of chip_smoke.py, rehearsed on the CPU.

chip_smoke.golden_train_record runs both families of the port's train
app on the dataset of radarml_tpu_torch/assets/golden_train.npz, and
chip_smoke.golden_train_check holds the result to the asset's bars
(tests/test_torch_train_golden.py explains them). On the card that is
phase 12's check against the JAX package; here the same code runs on the
CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_golden_record_on_cpu_meets_the_bars(tmp_path):
    """Phase 12's golden run (chip_smoke.golden_train_record) through the
    port's app on the CPU meets the asset's bars."""
    cs = _chip_smoke()
    g, got = cs.golden_train_record(str(tmp_path), torch.device("cpu"))
    out = cs.golden_train_check(got, g)
    assert out["svc_agree"] >= 0.98
    np.testing.assert_array_equal(got["svc_n_support"], g["svc_n_support"])
    assert out["svc_fold_dev_max"] <= out["svc_fold_bar"]

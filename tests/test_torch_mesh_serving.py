"""Sharded serving in the port: RadarPredictor with `mesh=` on two gloo
ranks, against the port's single call and the JAX package's predictor on
its 8-device mesh (tests/test_pallas_i8.py::test_fused_mesh_matches_single_chip
and tests/test_parallel.py::test_predictor_shards_over_mesh, on the port).

The ranks are processes that run a driver written to tmp_path (torch and
the port only). Rank 0 saves the inputs and weights it made from a seed;
the single calls here rebuild the predictors from them. The fused paths
are bit-equal to the single call; the float paths' decisions are equal
and their probabilities within 1e-6, since each rank contracts a batch
of half the size. Against JAX's sharded predictor the bars are the
port's own parity tests': fused decisions equal and probabilities within
1e-6; float probabilities within 1e-5 (5e-5 for the SVC,
tests/test_torch_svc_pipeline.py) and decisions equal wherever the JAX
top-2 margin and the distance to min_proba exceed 1e-4.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import Arena as JArena
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.models import svc as jsvc
from radarml_tpu.models.cnn import MultiViewCNN as JaxCNN
from radarml_tpu.models.linear import LinearModel as JLM, SigmoidCalibration as JSC
from radarml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarml_tpu_torch.apps.common_cli import neural_classifier
from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.models import cnn, svc as tsvc
from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.pipeline import RadarPredictor
from radarml_tpu_torch.parallel.spawn import run_ranks

torch.set_num_threads(1)

ARENA = dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0, theta_max=12.0,
             theta_res=4.0, phi_min=-6.0, phi_max=6.0, phi_res=2.0)  # (7, 7, 26)
B, T, C, RESCALE = 16, 3, 3, (16, 16)
FUSED = ["lookup", "glookup", "combo", "sel", "sel3"]

_DRIVER = r'''
import json, os, sys
import numpy as np
import torch
from radarml_tpu_torch.apps.common_cli import neural_classifier
from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.models import cnn, svc as tsvc
from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.pipeline import RadarPredictor
from radarml_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
out, arena_kw = sys.argv[1], json.loads(sys.argv[2])
B, T, C, RESCALE = 16, 3, 3, (16, 16)
tmesh.init_distributed(device="cpu")
mesh = tmesh.make_mesh(device="cpu")
rank = mesh.rank
arena = Arena(**arena_kw)
rng = np.random.default_rng(7)
F = arena.feature_length
inputs = dict(
    cubes=np.rint(rng.random((B,) + arena.grid_shape) * 255).astype(np.float32),
    xyz=np.concatenate([rng.uniform(-15, 15, (B, T, 2)), rng.uniform(15, 55, (B, T, 1))],
                       -1).astype(np.float32),
    valid=rng.random((B, T)) > 0.2,
    coef=(rng.normal(size=(C, F)) * 0.01).astype(np.float32),
    intercept=rng.normal(size=C).astype(np.float32),
    sv=rng.random((12, F)).astype(np.float32),
    dual=rng.normal(size=(C - 1, 12)).astype(np.float32),
    rho=rng.normal(size=3).astype(np.float32) * 0.1,
    probA=-np.abs(rng.normal(size=3)).astype(np.float32) - 1.0,
    probB=rng.normal(size=3).astype(np.float32) * 0.1,
)
if rank == 0:
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
cubes, xyz, valid = inputs["cubes"], inputs["xyz"], inputs["valid"]
lin = dict(train_arena=arena, scan_arena=arena, min_proba=0.5,
           model=LinearModel(coef=torch.as_tensor(inputs["coef"]),
                             intercept=torch.as_tensor(inputs["intercept"])),
           calibration=SigmoidCalibration(a=-torch.ones(C), b=torch.zeros(C)))
preds = {f"fused_{t}": RadarPredictor(mode="fused", fused_tail=t, mesh=mesh, **lin)
         for t in ("lookup", "glookup", "combo", "sel", "sel3")}
preds["fused_combo_single"] = RadarPredictor(mode="fused", fused_quant="single",
                                             mesh=mesh, **lin)
preds["fast"] = RadarPredictor(mode="fast", mesh=mesh, **lin)
preds["fast_int8"] = RadarPredictor(mode="fast", cube_dtype="int8", mesh=mesh, **lin)
preds["exact"] = RadarPredictor(mode="exact", mesh=mesh, **lin)
preds["pallas"] = RadarPredictor(mode="pallas", mesh=mesh, **lin)
preds["pallas_bf16"] = RadarPredictor(mode="pallas", cube_dtype="bfloat16", mesh=mesh, **lin)
svc = tsvc.from_numpy(inputs["sv"], inputs["dual"], inputs["rho"], (4, 4, 4),
                      kernel="rbf", gamma=0.05, probA=inputs["probA"],
                      probB=inputs["probB"], device="cpu")
preds["svc_exact"] = RadarPredictor(arena, arena, svc, min_proba=0.4, mode="exact",
                                    mesh=mesh)
module = cnn.init_cnn(C, RESCALE, seed=1, device="cpu")
preds["cnn"] = RadarPredictor(arena, arena, neural_classifier(module, RESCALE, "cpu"),
                              min_proba=0.4, mode="exact", mesh=mesh)
res = {}
for name, p in preds.items():
    pred, best, proba = p(cubes, xyz, valid)
    res.update({f"{name}.pred": pred.numpy(), f"{name}.best": best.numpy(),
                f"{name}.proba": proba.numpy()})
np.savez(os.path.join(out, f"outputs_r{rank}.npz"), **res)
errors = {}
for key, call in (("divisible", lambda: preds["fused_combo"](cubes[:9], xyz[:9], valid[:9])),
                  ("per shard", lambda: preds["fused_combo"](
                      cubes.reshape(B * cubes.shape[1], -1).astype(np.int8), xyz, valid)),
                  ("exact divisible", lambda: preds["exact"](cubes[:7], xyz[:7], valid[:7]))):
    try:
        call()
    except ValueError as e:
        errors[key] = str(e)
print(json.dumps({"errors": errors, "backend": mesh.backend, "device": str(mesh.device)}))
tmesh.close_distributed()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import json

    out = tmp_path_factory.mktemp("serving")
    driver = out / "driver.py"
    driver.write_text(_DRIVER)
    stdout = run_ranks([sys.executable, str(driver), str(out), json.dumps(ARENA)], 2, 150)
    reports = [json.loads(s.strip().splitlines()[-1]) for s in stdout]
    outs = [dict(np.load(out / f"outputs_r{r}.npz")) for r in range(2)]
    return dict(np.load(out / "inputs.npz")), outs, reports


def _port_single(inputs, name):
    arena = Arena(**ARENA)
    lin = dict(train_arena=arena, scan_arena=arena, min_proba=0.5,
               model=LinearModel(coef=torch.as_tensor(inputs["coef"]),
                                 intercept=torch.as_tensor(inputs["intercept"])),
               calibration=SigmoidCalibration(a=-torch.ones(C), b=torch.zeros(C)))
    if name.startswith("fused_"):
        tail = name.split("_")[1]
        quant = "single" if name.endswith("single") else "split"
        return RadarPredictor(mode="fused", fused_tail=tail, fused_quant=quant, **lin)
    if name == "svc_exact":
        svc = tsvc.from_numpy(inputs["sv"], inputs["dual"], inputs["rho"], (4, 4, 4),
                              kernel="rbf", gamma=0.05, probA=inputs["probA"],
                              probB=inputs["probB"], device="cpu")
        return RadarPredictor(arena, arena, svc, min_proba=0.4, mode="exact")
    if name == "cnn":
        module = cnn.init_cnn(C, RESCALE, seed=1, device="cpu")
        return RadarPredictor(arena, arena, neural_classifier(module, RESCALE, "cpu"),
                              min_proba=0.4, mode="exact")
    mode, _, dtype = name.partition("_")
    dtype = {"": "float32", "int8": "int8", "bf16": "bfloat16"}[dtype]
    return RadarPredictor(mode=mode, cube_dtype=dtype, **lin)


def _jax_sharded(inputs, name):
    arena = JArena(**ARENA)
    mesh = jax_make_mesh(8)
    lin = dict(train_arena=arena, scan_arena=arena, min_proba=0.5, mesh=mesh,
               model=JLM(coef=jnp.asarray(inputs["coef"]),
                         intercept=jnp.asarray(inputs["intercept"])),
               calibration=JSC(a=-jnp.ones((C,)), b=jnp.zeros((C,))))
    if name.startswith("fused_"):
        return jpipe.RadarPredictor(mode="fused", fused_tail=name.split("_")[1], **lin)
    if name == "svc_exact":
        svc = jsvc.SVCModel(jnp.asarray(inputs["sv"]), jnp.asarray(inputs["dual"]),
                            jnp.asarray(inputs["rho"]), (4, 4, 4), kernel="rbf", gamma=0.05,
                            probA=jnp.asarray(inputs["probA"]),
                            probB=jnp.asarray(inputs["probB"]))
        return jpipe.RadarPredictor(arena, arena, svc, min_proba=0.4, mode="exact",
                                    mesh=mesh)
    if name == "cnn":
        module, tree = JaxCNN(n_classes=C), cnn.cnn_init_tree(C, RESCALE, seed=1)
        clf = jpipe.NeuralClassifier(
            apply=lambda v: module.apply({"params": tree}, v, train=False),
            rescale=RESCALE, n_classes=C)
        return jpipe.RadarPredictor(arena, arena, clf, min_proba=0.4, mode="exact",
                                    mesh=mesh)
    mode, _, dtype = name.partition("_")
    dtype = {"": "float32", "int8": "int8", "bf16": "bfloat16"}[dtype]
    return jpipe.RadarPredictor(mode=mode, cube_dtype=dtype, **lin)


def _inputs(inputs):
    return inputs["cubes"], inputs["xyz"], inputs["valid"]


def test_every_rank_returns_the_whole_batch(ranks):
    _, outs, reports = ranks
    assert set(outs[0]) == set(outs[1])
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)
        assert outs[0][key].shape[:2] == (B, T)
    assert [r["backend"] for r in reports] == ["gloo", "gloo"]


def test_refusals(ranks):
    _, _, reports = ranks
    for rep in reports:
        assert "divisible" in rep["errors"]["divisible"]
        assert "per shard" in rep["errors"]["per shard"]
        assert "divisible" in rep["errors"]["exact divisible"]


@pytest.mark.parametrize("name", [f"fused_{t}" for t in FUSED] + ["fused_combo_single"])
def test_fused_sharded_bit_equal_to_single(ranks, name):
    inputs, outs, _ = ranks
    want = _port_single(inputs, name)(*_inputs(inputs))
    for i, part in enumerate(("pred", "best", "proba")):
        np.testing.assert_array_equal(outs[0][f"{name}.{part}"], want[i].numpy())


@pytest.mark.parametrize("name", ["fast", "fast_int8", "exact", "pallas", "pallas_bf16",
                                  "svc_exact", "cnn"])
def test_float_paths_sharded_match_single(ranks, name):
    inputs, outs, _ = ranks
    want = _port_single(inputs, name)(*_inputs(inputs))
    np.testing.assert_array_equal(outs[0][f"{name}.pred"], want[0].numpy())
    np.testing.assert_allclose(outs[0][f"{name}.proba"], want[2].numpy(), atol=1e-6)


@pytest.mark.parametrize("tail", ["glookup", "combo", "sel3"])
def test_fused_sharded_matches_jax_sharded(ranks, tail):
    inputs, outs, _ = ranks
    jp, _, jq = _jax_sharded(inputs, f"fused_{tail}")(*_inputs(inputs))
    np.testing.assert_array_equal(outs[0][f"fused_{tail}.pred"], np.asarray(jp))
    np.testing.assert_allclose(outs[0][f"fused_{tail}.proba"], np.asarray(jq), atol=1e-6)


@pytest.mark.parametrize("name,atol", [("exact", 1e-5), ("pallas", 1e-5),
                                       ("svc_exact", 5e-5), ("cnn", 1e-5)])
def test_sharded_matches_jax_sharded(ranks, name, atol):
    inputs, outs, _ = ranks
    jp, _, jq = _jax_sharded(inputs, name)(*_inputs(inputs))
    jq = np.asarray(jq)
    np.testing.assert_allclose(outs[0][f"{name}.proba"], jq, atol=atol)
    top2 = np.sort(jq, axis=-1)[..., -2:]
    thr = 0.4 if name in ("svc_exact", "cnn") else 0.5
    clear = (top2[..., 1] - top2[..., 0] > 1e-4) & (np.abs(jq.max(-1) - thr) > 1e-4)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(outs[0][f"{name}.pred"][clear], np.asarray(jp)[clear])

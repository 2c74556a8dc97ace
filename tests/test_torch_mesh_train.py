"""Data-parallel training in the port on two gloo ranks, against the
same runs on one device and the JAX package's mesh runs: the CNN
(tests/test_cnn.py::test_train_cnn_mesh_matches_single_device), the
SGAN's global BatchNorm and fused step, the sharded SGD and SVC grids
(tests/test_gridsearch.py's mesh cases) and `apps.dnn --mesh 2` under
torch.distributed.run.

Each rank is a process that runs `_RUNS` (torch and the port only) from
a driver written to tmp_path; this module runs the same functions with
mesh=None. Bars, and why:

- the CNN history within rtol 1e-4 of one device (the JAX test's bar):
  the sharded gradient sums in another order, and Adam carries that on;
  against the JAX mesh run (dropout off on both sides) the bars of
  tests/test_torch_cnn.py, rtol 1e-4 and parameters within 1e-5;
- FlaxBatchNorm with global statistics: output, input gradient, scale
  and bias gradients and running statistics within 1e-5 of one rank on
  the whole batch;
- the SGAN step: at lr 0 (the parameters stay put, so the Adam moments
  are the gradients of all four phases at one point) three steps with
  dropout on, their masks drawn whole and sliced: losses within rtol
  1e-5, moments within rtol 1e-4 of one device (atol 1e-4 of the tree's
  largest, for the gradients that are zero but for rounding), statistics
  within 1e-5. At lr 2e-4, one step with dropout on and off and three
  with it off, as tests/test_torch_sgan.py runs them: each tree disagrees
  (atol + 1e-3·|value|, the atols of that file) on at most twice the
  share, plus 1e-4, on which one device disagrees with itself from
  weights one float32 ulp up or down, and each loss lies within twice
  that spread plus rtol 1e-5. That file's fixed bars (rtol 1e-4 on the
  third losses, 2·lr per Adam update) do not hold here: one ulp moves
  this run's third losses by up to 6e-4 relative. With dropout on, one
  ulp moves 10-95% of the moments after three steps, so that comparison
  is left to the lr 0 run;
- the SGD grid's split scores equal, also at 2,000 features, where a
  fold's walk took another route when it walked alone; the SVC grid's
  best parameters equal and scores within 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radarml_tpu.models.cnn import MultiViewCNN as JaxCNN
from radarml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarml_tpu.train import trainer as jtrainer
from radarml_tpu_torch.parallel.spawn import run_ranks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNS = r'''
import numpy as np
import torch
from radarml_tpu_torch.models import cnn, sgan
from radarml_tpu_torch.models.sgan import FlaxBatchNorm, global_batch_stats
from radarml_tpu_torch.train import gridsearch as tg, sgan_trainer as st, trainer
from radarml_tpu_torch.train.trainer import all_reduce_grads, seeded_generator

SMALL = (16, 16)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)  # a copy: .numpy() shares memory
    return out


def cnn_run(mesh, dropout):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(32,) + SMALL + (3,)).astype(np.float32)
    y = (np.arange(32) % 3).astype(np.int64)
    model = cnn.init_cnn(3, SMALL, seed=0, device="cpu", dropout_rate=dropout)
    best, hist = trainer.train_cnn(model, X, y, X[:8], y[:8], mesh=mesh,
                                   config=trainer.TrainConfig(batch_size=8, epochs=3,
                                                              patience=10))
    out = {f"hist/{k}": np.asarray(v) for k, v in hist.items()}
    out.update({f"best/{k}": v.numpy() for k, v in best.items()})
    return out


def bn_run(mesh):
    rng = np.random.default_rng(5)
    out = {}
    for shape in ((8, 4, 5, 5), (8, 6)):
        x = rng.normal(size=shape).astype(np.float32) * 2 + 1
        w = rng.normal(size=shape).astype(np.float32)
        bn = FlaxBatchNorm(shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, shape[1])))
            bn.bias.copy_(torch.as_tensor(rng.normal(size=shape[1])))
        rows = slice(None) if mesh is None else mesh.rows(shape[0])
        xl = torch.tensor(x[rows], requires_grad=True)
        with global_batch_stats(mesh, bn):
            y = bn(xl, True)
        (y * torch.as_tensor(w[rows])).sum().backward()
        if mesh is not None:
            all_reduce_grads(mesh, [bn.weight, bn.bias])
            y, gx = mesh.all_gather(y.detach()), mesh.all_gather(xl.grad)
        else:
            gx = xl.grad
        tag = len(shape)
        out.update({f"{tag}/y": y.detach().numpy(), f"{tag}/gx": gx.numpy(),
                    f"{tag}/gw": bn.weight.grad.numpy(), f"{tag}/gb": bn.bias.grad.numpy(),
                    f"{tag}/rm": bn.running_mean.numpy(), f"{tag}/rv": bn.running_var.numpy()})
    return out


def sgan_run(mesh, dropout, nudge=0, lr=2e-4):
    (gp, gs), (dp, ds) = sgan.sgan_init_trees(3, SMALL, seed=0)
    if nudge:  # every weight one float32 ulp up (+1) or down (-1)
        gp, dp = (_map(t, lambda a: np.nextafter(a, np.float32(nudge * np.inf)))
                  for t in (gp, dp))
    G = sgan.Generator(1)
    G.load_state_dict(sgan.sgan_params_from_numpy(gp, gs))
    D = sgan.Discriminator(3, SMALL, dropout_rate=dropout)
    D.load_state_dict(sgan.sgan_params_from_numpy(dp, ds))
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, seed=0, learning_rate=lr)
    state = st.make_state(G, D, cfg)
    step = st.make_sgan_step(G, D, cfg, real_weight=1.3, mesh=mesh)
    rng = np.random.default_rng(0)
    out = {}
    for s in range(3):
        sv = torch.as_tensor(rng.normal(size=(4,) + SMALL + (3,)).astype(np.float32))
        sl = torch.as_tensor(np.array([0, 1, 2, 0]))
        rv = torch.as_tensor(rng.normal(size=(4,) + SMALL + (3,)).astype(np.float32))
        draws = st.draw_step(cfg, 4, D, seeded_generator(torch.device("cpu"), 0, s))
        state, losses = step(state, sv, sl, rv, draws)
        out.update({f"loss{s}/{k}": float(v) for k, v in losses.items()})
        if s in (0, 2):
            out.update(snapshot(G, D, state, f"s{s + 1}/"))
    return out


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(np.asarray(v))
            for k, v in tree.items()}


def snapshot(G, D, state, prefix):
    out = {}
    for name, net in (("g", G), ("d", D)):
        params, stats = sgan.sgan_params_to_numpy(net)
        out.update({f"{prefix}{name}_params/{k}": v for k, v in flat(params).items()})
        out.update({f"{prefix}{name}_stats/{k}": v for k, v in flat(stats).items()})
    for oname, opt, nets in (("c", state.c_opt, [("d", D)]), ("d", state.d_opt, [("d", D)]),
                             ("gan", state.gan_opt, [("g", G), ("d", D)])):
        for net_name, net in nets:
            for n, p in net.named_parameters():
                for m in ("exp_avg", "exp_avg_sq"):
                    out[f"{prefix}{oname}_{net_name}_{m}/{n}"] = opt.state[p][m].numpy().copy()
    return out


def blobs(rng, n, k, f):
    centers = rng.normal(size=(k, f)) * 3.0
    y = np.arange(n) % k
    return (centers[y] + rng.normal(size=(n, f))).astype(np.float32), y


def grid_runs(mesh):
    out = {}
    sgd_grid = [{"alpha": [1e-4, 1e-3], "penalty": ["l2"], "average": [False]},
                {"alpha": [1e-4], "penalty": ["l1"], "average": [False]}]
    for tag, f in (("sgd", 12), ("sgd_wide", 2000)):
        X, y = blobs(np.random.default_rng(1234), 45, 3, f)
        res = tg.grid_search_sgd(X, y, folds=3, grid=sgd_grid, epochs=6, mesh=mesh,
                                 device="cpu")
        out[f"{tag}/scores"] = np.array([r["split_scores"] for r in res.cv_results])
        out[f"{tag}/best"] = np.array(sorted(res.best_params.items()), dtype=object).astype(str)
    X, y = blobs(np.random.default_rng(1234), 42, 3, 10)
    svc_grid = [{"C": [0.1, 1.0, 10.0, 100.0], "kernel": ["linear"]},
                {"C": [1.0, 10.0], "gamma": [0.05], "kernel": ["rbf"]}]
    res = tg.grid_search_svc(X, y, folds=3, grid=svc_grid, probability=False, mesh=mesh,
                             device="cpu")
    out["svc/scores"] = np.array([r["split_scores"] for r in res.cv_results])
    out["svc/best"] = np.array(sorted(res.best_params.items()), dtype=object).astype(str)
    out["svc/iters"] = np.array(sorted(res.smo_iters.items()), dtype=object).astype(str)
    return out
'''

_DRIVER = _RUNS + r'''
import os, sys
from radarml_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
tmesh.init_distributed(device="cpu")
mesh = tmesh.make_mesh(device="cpu")
out = {}
for name, run in (("cnn", lambda: cnn_run(mesh, 0.5)), ("cnn0", lambda: cnn_run(mesh, 0.0)),
                  ("bn", lambda: bn_run(mesh)), ("sgan", lambda: sgan_run(mesh, 0.0)),
                  ("sgan_drop", lambda: sgan_run(mesh, 0.5)),
                  ("sgan_grad", lambda: sgan_run(mesh, 0.5, lr=0.0)),
                  ("grid", lambda: grid_runs(mesh))):
    out.update({f"{name}:{k}": v for k, v in run().items()})
np.savez(os.path.join(sys.argv[1], f"r{mesh.rank}.npz"), **out)
print("done")
tmesh.close_distributed()
'''

RUNS = {}
exec(_RUNS, RUNS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    driver = out / "driver.py"
    driver.write_text(_DRIVER)
    run_ranks([sys.executable, str(driver), str(out)], 2, 200)
    return [dict(np.load(out / f"r{r}.npz")) for r in range(2)]


def _part(res, name):
    return {k.split(":", 1)[1]: v for k, v in res.items() if k.startswith(name + ":")}


def test_ranks_hold_the_same_results(ranks):
    a, b = ranks
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dropout", [0.5, 0.0])
def test_train_cnn_mesh_matches_single_device(ranks, dropout):
    got = _part(ranks[0], "cnn" if dropout else "cnn0")
    want = RUNS["cnn_run"](None, dropout)
    for k in ("loss", "val_loss", "accuracy", "val_accuracy"):
        np.testing.assert_allclose(got[f"hist/{k}"], want[f"hist/{k}"], rtol=1e-4, err_msg=k)


def test_train_cnn_mesh_matches_jax_mesh(ranks):
    """Dropout off on both sides: the port on two ranks against the JAX
    package's train_cnn on its 8-device mesh, same weights and data."""
    from radarml_tpu_torch.models import cnn

    got = _part(ranks[0], "cnn0")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(32, 16, 16, 3)).astype(np.float32)
    y = (np.arange(32) % 3).astype(np.int64)
    jbest, jhist = jtrainer.train_cnn(
        JaxCNN(n_classes=3, dropout_rate=0.0), cnn.cnn_init_tree(3, (16, 16), seed=0),
        X, y, X[:8], y[:8], config=jtrainer.TrainConfig(batch_size=8, epochs=3, patience=10),
        mesh=jax_make_mesh(8))
    for k in jhist:
        np.testing.assert_allclose(got[f"hist/{k}"], jhist[k], rtol=1e-4, err_msg=k)
    best = cnn.cnn_params_to_numpy({k[5:]: torch.as_tensor(v) for k, v in got.items()
                                    if k.startswith("best/")})
    flat_got = RUNS["flat"](best)
    flat_want = RUNS["flat"](jbest)
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], np.asarray(flat_want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_flax_batchnorm_global_statistics(ranks):
    got, want = _part(ranks[0], "bn"), RUNS["bn_run"](None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _frac(got, want, keys, atol):
    close = total = 0
    for k in keys:
        a, b = got[k], want[k]
        close += int((np.abs(a - b) <= atol + 1e-3 * np.abs(b)).sum())
        total += a.size
    return close / total


def _trees(res, prefix):
    groups = {}
    for k in res:
        if k.startswith(prefix):
            groups.setdefault(k[len(prefix):].split("/")[0], []).append(k)
    return groups


def _atol(tree):
    return 1e-10 if tree.endswith("exp_avg_sq") else 1e-6 if "exp_avg" in tree else 1e-5


@pytest.fixture(scope="module")
def sgan_single():
    """One device's runs, from the weights and from them one ulp up and
    down, for each dropout rate."""
    return {(d, nudge): RUNS["sgan_run"](None, d, nudge=nudge)
            for d in (0.0, 0.5) for nudge in (0, 1, -1)}


def test_sgan_step_gradients_sharded_equal_single_device(ranks):
    """At lr 0 the parameters stay put, so after one step each Adam first
    moment is a fixed multiple of its phase's gradient at the same point,
    and the second moment of its square: the sharded step's gradients of
    all four phases (global BatchNorm, sliced dropout masks, the frozen
    discriminator in the GAN phase) against one device's."""
    got, want = _part(ranks[0], "sgan_grad"), RUNS["sgan_run"](None, 0.5, lr=0.0)
    for k in want:
        if k.startswith("loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for prefix in ("s1/", "s3/"):
        for tree, keys in _trees(want, prefix).items():
            # a gradient that is zero but for rounding (a bias in front of a
            # BatchNorm) is held to its tree's scale
            scale = max(np.abs(want[k]).max() for k in keys)
            for k in keys:
                rtol, atol = (1e-4, 1e-4 * scale) if "exp_avg" in tree else (1e-5, 1e-6)
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("n_steps,dropout", [(1, 0.0), (1, 0.5), (3, 0.0)],
                         ids=["1-no-dropout", "1-dropout", "3-no-dropout"])
def test_sgan_steps_sharded_match_single_device(ranks, sgan_single, n_steps, dropout):
    got = _part(ranks[0], "sgan_drop" if dropout else "sgan")
    want = sgan_single[dropout, 0]
    spread = [sgan_single[dropout, 1], sgan_single[dropout, -1]]
    for s in range(n_steps):
        for k in ("c_loss", "c_acc", "d_real", "d_fake", "gan"):
            key = f"loss{s}/{k}"
            own = max(abs(o[key] - want[key]) for o in spread)
            assert abs(got[key] - want[key]) <= 2 * own + 1e-5 * abs(want[key]), key
    prefix = f"s{n_steps}/"
    for tree, keys in _trees(want, prefix).items():
        share = 1.0 - _frac(got, want, keys, _atol(tree))
        bar = 2 * max(1.0 - _frac(o, want, keys, _atol(tree)) for o in spread) + 1e-4
        assert share <= bar, (tree, share, bar)
    # the GAN phase moves only BatchNorm in the discriminator
    for k in got:
        if k.startswith(prefix + "gan_d_exp_avg/") and "BatchNorm" not in k:
            assert not got[k].any(), k


@pytest.mark.parametrize("search", ["sgd", "sgd_wide", "svc"])
def test_grids_sharded_match_single_device(ranks, search):
    got, want = _part(ranks[0], "grid"), RUNS["grid_runs"](None)
    np.testing.assert_array_equal(got[f"{search}/best"], want[f"{search}/best"])
    if search == "svc":
        np.testing.assert_allclose(got["svc/scores"], want["svc/scores"], atol=1e-6)
        np.testing.assert_array_equal(got["svc/iters"], want["svc/iters"])
    else:
        np.testing.assert_array_equal(got[f"{search}/scores"], want[f"{search}/scores"])


def test_dnn_app_mesh_under_torchrun(tmp_path):
    """`apps.dnn --mesh 2 --platform cpu` under torch.distributed.run: the
    history within rtol 1e-4 of `--mesh 0`, and only rank 0 writes."""
    from radarml_tpu_torch.apps import dnn as dnn_app

    args = ["--platform", "cpu", "--synthetic", "48", "--epochs", "3", "--batch_size", "8"]
    single = dnn_app.main(args + ["--results_dir", str(tmp_path / "one")])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    # --standalone: the launcher binds its store's port itself (port 0)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "radarml_tpu_torch.apps.dnn", "--mesh", "2",
           "--results_dir", str(tmp_path / "two")] + args
    done = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, timeout=180)
    assert done.returncode == 0, done.stderr.decode()[-3000:]
    written = sorted(os.listdir(tmp_path / "two"))
    assert "c_model.pickle" in written and "train.log" in written
    import pickle

    with open(tmp_path / "two" / "c_model.pickle", "rb") as f:
        hist = pickle.load(f)["history"]
    for k, v in single["history"].items():
        np.testing.assert_allclose(hist[k], v, rtol=1e-4, err_msg=k)
    log = (tmp_path / "two" / "train.log").read_text()
    assert "mesh (2,) over gloo, rank 0 on cpu" in log

"""models/cnn.py, train/trainer.py and train/checkpoint.py of the port
against the JAX package's.

Weights are made once with numpy (models/cnn.cnn_init_tree) and go into
both packages: the flax tree as it is into the JAX module, through
cnn_params_from_numpy into the port's. Tolerances:

- forward logits within 1e-5 of max|logits| (measured ~1e-6 relative at
  16×16 and 80×80: the same float32 products in another order);
- three epochs of train_cnn without dropout, from the same weights and
  seed (hence the same permutations): history within rtol 1e-4 and
  best parameters within atol 1e-5 (measured ~5e-6 relative and 6e-7:
  Adam with ε 1e-8 on gradients that differ in the last bits);
- a run killed at epoch 8 and resumed equals the 12-epoch run exactly
  (the same operations on the same CPU).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radarml_tpu.models.cnn import MultiViewCNN as JaxCNN
from radarml_tpu.train import trainer as jtrainer
from radarml_tpu_torch.models import cnn
from radarml_tpu_torch.train import trainer
from radarml_tpu_torch.train.checkpoint import CheckpointStore

LOGIT_RTOL = 1e-5
HIST_RTOL, PARAM_ATOL = 1e-4, 1e-5

torch.set_num_threads(1)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def separable(n, rescale, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % 3).astype(np.int64)
    X = rng.normal(size=(n,) + rescale + (3,)).astype(np.float32) * scale
    for c in range(3):
        X[y == c, :, :, c] += 1.0
    return X, y


@pytest.mark.parametrize("rescale", [(16, 16), (80, 80), (13, 9)])
def test_forward_matches_jax(rescale):
    tree = cnn.cnn_init_tree(3, rescale, seed=0)
    jparams = JaxCNN(n_classes=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + rescale + (3,)), train=False)["params"]
    assert jax.tree.structure(jparams) == jax.tree.structure(tree)
    assert [a.shape for a in leaves(jparams)] == [a.shape for a in leaves(tree)]
    x = np.random.default_rng(1).uniform(-1, 1, (6,) + rescale + (3,)).astype(np.float32)
    want = np.asarray(JaxCNN(n_classes=3).apply({"params": tree}, x, train=False))
    model = cnn.init_cnn(3, rescale, seed=0, device="cpu")
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max())
    proba = cnn.cnn_predict_proba(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(proba.sum(-1), 1.0, rtol=1e-6)


def test_params_round_trip_bit_for_bit():
    tree = cnn.cnn_init_tree(3, cnn.RESCALE, seed=5)
    model = cnn.MultiViewCNN(3, cnn.RESCALE)
    model.load_state_dict(cnn.cnn_params_from_numpy(tree))
    back = cnn.cnn_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the three branches each hold their own 64→32 banks (dnn.py:45-52)
    for b in ("branch_xz", "branch_yz", "branch_xy"):
        assert sorted(v["kernel"].shape[-1] for v in back[b].values()) == [32, 64]


def test_same_padding_follows_lax():
    assert cnn.same_padding(80, 3, 2) == (0, 1)
    assert cnn.same_padding(40, 3, 2) == (0, 1)
    assert cnn.same_padding(13, 3, 2) == (1, 1)
    assert cnn.same_padding(128, 7, 1) == (3, 3)


@pytest.mark.parametrize("hw", [(16, 16), (13, 9)])
def test_single_output_conv_matches_conv2d(hw):
    """SameConv2d's tap route (one output channel, stride 1) computes
    F.conv2d with SAME padding, values and gradients, in float64."""
    torch.manual_seed(0)
    conv = cnn.SameConv2d(5, 1, 7).double()
    x = torch.randn((3, 5) + hw, dtype=torch.float64, requires_grad=True)
    # a channels-last input too, as the generator's first layers give it
    torch.testing.assert_close(conv(x.to(memory_format=torch.channels_last)), conv(x),
                               rtol=0, atol=1e-12)
    got = conv(x)
    want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, 1, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    g = torch.randn_like(want)
    for a, b in zip(torch.autograd.grad(got, (x, conv.weight, conv.bias), g),
                    torch.autograd.grad(want, (x, conv.weight, conv.bias), g)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-11)


def test_weighted_loss_matches_keras_semantics_and_jax():
    logits = np.asarray([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.3, -1.0, 0.5]], np.float32)
    y = np.asarray([0, 1, 2])
    w = np.asarray([2.0, 1.0, 0.5], np.float32)
    got = float(trainer.weighted_xent_loss(torch.from_numpy(logits), torch.from_numpy(y),
                                           torch.from_numpy(w)))
    want = float(jtrainer.weighted_xent_loss(jnp.asarray(logits), jnp.asarray(y),
                                             jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    nll = -np.log(np.exp(2.0) / (np.exp(2.0) + 2.0))
    got2 = float(trainer.weighted_xent_loss(torch.from_numpy(logits[:2]),
                                            torch.from_numpy(y[:2]), torch.from_numpy(w)))
    np.testing.assert_allclose(got2, (2.0 * nll + nll) / 3.0, rtol=1e-6)


def test_train_cnn_three_epochs_match_jax():
    rescale = (16, 16)
    X, y = separable(48, rescale, 0)
    tree = cnn.cnn_init_tree(3, rescale, seed=0)
    w = {0: 1.0, 1: 2.0, 2: 1.5}
    jbest, jhist = jtrainer.train_cnn(
        JaxCNN(n_classes=3, dropout_rate=0.0), tree, X[:36], y[:36], X[36:], y[36:],
        w_classes=w, config=jtrainer.TrainConfig(batch_size=8, epochs=3))
    model = cnn.init_cnn(3, rescale, seed=0, device="cpu", dropout_rate=0.0)
    best, hist = trainer.train_cnn(model, X[:36], y[:36], X[36:], y[36:], w_classes=w,
                                   config=trainer.TrainConfig(batch_size=8, epochs=3))
    assert set(hist) == set(jhist)
    for k in jhist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=HIST_RTOL)
    for a, b in zip(leaves(cnn.cnn_params_to_numpy(best)), leaves(jbest)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_train_cnn_learns_separable_data():
    rescale = (16, 16)
    X, y = separable(48, rescale, 0)
    model = cnn.init_cnn(3, rescale, seed=0, device="cpu")
    cfg = trainer.TrainConfig(batch_size=16, epochs=15, patience=5)
    best, history = trainer.train_cnn(model, X[:36], y[:36], X[36:], y[36:], config=cfg)
    assert max(history["val_accuracy"]) > 0.6
    assert len(history["loss"]) <= cfg.epochs
    # the model ends holding the best parameters, which reproduce the best
    # recorded val accuracy
    logits = model(torch.from_numpy(X[36:])).detach().numpy()
    acc = float((logits.argmax(1) == y[36:]).mean())
    np.testing.assert_allclose(acc, max(history["val_accuracy"]), atol=1e-6)
    for k, v in best.items():
        assert torch.equal(model.state_dict()[k], v)


def test_early_stopping_triggers():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=12).astype(np.int64)  # unlearnable noise
    model = cnn.init_cnn(3, (16, 16), seed=0, device="cpu")
    _, history = trainer.train_cnn(model, X, y, X, y,
                                   config=trainer.TrainConfig(batch_size=6, epochs=100,
                                                              patience=3))
    assert len(history["loss"]) < 100


def test_train_cnn_dataset_smaller_than_batch():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(9, 16, 16, 3)).astype(np.float32)
    y = (np.arange(9) % 3).astype(np.int64)
    model = cnn.init_cnn(3, (16, 16), seed=0, device="cpu")
    _, history = trainer.train_cnn(model, X, y, X, y,
                                   config=trainer.TrainConfig(batch_size=64, epochs=2))
    assert len(history["loss"]) == 2
    assert np.isfinite(history["loss"]).all()


def test_patience_zero_trains_and_stops_at_first_plateau():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(24, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(24,)).astype(np.int32)
    model = cnn.init_cnn(3, (8, 8), seed=0, device="cpu")
    _, history = trainer.train_cnn(model, X, y, X, y,
                                   config=trainer.TrainConfig(batch_size=8, epochs=50,
                                                              patience=0))
    assert 1 <= len(history["loss"]) <= 50


def test_mesh_raises():
    model = cnn.init_cnn(3, (8, 8), seed=0, device="cpu")
    X = np.zeros((4, 8, 8, 3), np.float32)
    y = np.zeros(4, np.int64)
    with pytest.raises(NotImplementedError, match="A15"):
        trainer.train_cnn(model, X, y, X, y, mesh=object())


def test_checkpoint_kill_and_resume_reproduces_uninterrupted_run(tmp_path):
    rescale = (16, 16)
    X, y = separable(36, rescale, 3)
    Xv, yv = X[:12], y[:12]
    cfg = trainer.TrainConfig(batch_size=12, epochs=12, patience=50)

    full = cnn.init_cnn(3, rescale, seed=0, device="cpu")
    best_full, hist_full = trainer.train_cnn(full, X, y, Xv, yv, config=cfg)

    # "Crash" at epoch 8: run only 8 epochs with checkpoints...
    ckpt = str(tmp_path / "cnn_ckpt")
    trainer.train_cnn(cnn.init_cnn(3, rescale, seed=0, device="cpu"), X, y, Xv, yv,
                      config=trainer.TrainConfig(batch_size=12, epochs=8, patience=50),
                      checkpoint_dir=ckpt, checkpoint_every=4)
    assert CheckpointStore(ckpt).latest_step() == 8
    # ...then resume the 12-epoch schedule from the latest checkpoint.
    best_res, hist_res = trainer.train_cnn(
        cnn.init_cnn(3, rescale, seed=9, device="cpu"), X, y, Xv, yv, config=cfg,
        checkpoint_dir=ckpt, checkpoint_every=4, resume=True)
    assert hist_res == hist_full
    for k in best_full:
        assert torch.equal(best_res[k], best_full[k]), k


def test_dropout_masks_follow_flax_scaling():
    g = torch.Generator().manual_seed(0)
    (m,) = cnn.dropout_masks(1, (4000,), 0.5, g)
    assert set(np.unique(m.numpy())) <= {0.0, 2.0}
    assert 0.45 < float((m > 0).to(torch.float32).mean()) < 0.55
    assert cnn.dropout_masks(2, (3,), 0.0, g) is None


class Pair(collections.namedtuple("Pair", "w count")):
    pass


def test_store_round_trip_with_namedtuple_structure(tmp_path):
    """The port of tests/test_checkpoint.py's store case: a NamedTuple
    optimizer-like state and torch state dicts come back intact."""
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=1e-3)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    state = Pair(w=torch.ones(2), count=np.int64(3))
    store = CheckpointStore(str(tmp_path), max_to_keep=2)
    store.save(1, {"params": params, "opt": opt.state_dict(), "pair": state},
               meta={"note": "first"})
    store.save(5, {"params": params, "opt": opt.state_dict(), "pair": state})
    assert store.latest_step() == 5
    template = {"params": params, "opt": opt.state_dict(), "pair": Pair(None, None)}
    step, tree, meta = store.restore(template=template)
    assert step == 5 and meta == {}
    assert isinstance(tree["pair"], Pair) and torch.equal(tree["pair"].w, torch.ones(2))
    torch.testing.assert_close(tree["params"]["w"], torch.arange(6.0).reshape(2, 3))
    opt2 = torch.optim.Adam(lin.parameters(), lr=1e-3)
    opt2.load_state_dict(tree["opt"])  # optimizer state restored intact → steps
    opt2.step()
    assert store.restore(step=1)[2] == {"note": "first"}
    store.close()


def test_store_retention(tmp_path):
    store = CheckpointStore(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"x": np.ones(2) * s})
    assert store.latest_step() == 4
    assert torch.equal(store.restore()[1]["x"], torch.full((2,), 4.0, dtype=torch.float64))
    with pytest.raises(FileNotFoundError):
        store.restore(step=1)  # aged out
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore()


def test_adam_matches_optax_on_one_update():
    """The port's Adam settings (β1 0.5, ε 1e-8) take the optax step."""
    w0 = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    tx = optax.adam(2e-4, b1=0.5)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w0)), jnp.asarray(w0))
    want = np.asarray(optax.apply_updates(jnp.asarray(w0), upd))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([p], lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-7)

"""models/sgan.py and train/sgan_trainer.py of the port against the JAX
package's.

Weights are made once with numpy (models/sgan.sgan_init_trees) and carried
into both packages. Tolerances, and why:

- forward outputs of both networks, in eval and train mode, within 1e-5
  of max|output| (measured ≤ 5e-6 relative; BatchNorm statistics reduce
  in another order), and the BatchNorm statistics after one train-mode
  call within 1e-5 absolute (measured ≤ 6e-8).
- the fused four-phase step, on the JAX step's own z and label draws and
  with dropout off on both sides. Adam divides each gradient element by
  its magnitude plus ε (1e-7): where a gradient element is near zero —
  always for the biases in front of a BatchNorm, whose gradient is zero
  up to rounding — last-bit differences move that element's update by up
  to the learning rate, and later steps carry the difference on. So: the
  losses within rtol 1e-5 after one step and 1e-4 after three; every
  parameter within 2·lr per Adam update it received (the most two Adam
  updates of one element can part); equal Adam step counts. An element
  "agrees" within atol + 1e-3·|JAX value| (atol 1e-5 for parameters and
  statistics, 1e-6 for first moments, 1e-10 for second moments). After
  one step at least 99.5% of each network's parameters agree, 99% of each
  moment tree and all statistics (measured: 99.9% / 99.7% / 100%). After
  three steps each tree disagrees on at most twice the share of elements
  (plus 1e-4) on which the JAX step disagrees with itself run from
  weights one float32 ulp up (the port measured e.g. 78% of the
  generator's GAN first moments in agreement, against JAX's own 5%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radarml_tpu.models import sgan as jsgan
from radarml_tpu.train import sgan_trainer as jst
from radarml_tpu_torch.models import sgan
from radarml_tpu_torch.train import sgan_trainer as st
from radarml_tpu_torch.train.checkpoint import CheckpointStore

SMALL = (16, 16)
LR = 2e-4

torch.set_num_threads(1)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def perturbed_stats(stats, seed):
    """Non-trivial running statistics, so that eval mode reads them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if "var" in jax.tree_util.keystr(p)
                      else rng.normal(0, 0.1, a.shape)).astype(np.float32), stats)


@pytest.fixture(scope="module")
def trees():
    (gp, gs), (dp, ds) = sgan.sgan_init_trees(3, SMALL, seed=0)
    return gp, perturbed_stats(gs, 1), dp, perturbed_stats(ds, 2)


def port_nets(trees, dropout_rate=0.0):
    gp, gs, dp, ds = trees
    G = sgan.Generator(1)
    G.load_state_dict(sgan.sgan_params_from_numpy(gp, gs))
    D = sgan.Discriminator(3, SMALL, dropout_rate=dropout_rate)
    D.load_state_dict(sgan.sgan_params_from_numpy(dp, ds))
    return G, D


def split(x):
    return tuple(x[..., i:i + 1] for i in range(3))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_networks_match_jax(trees, train):
    gp, gs, dp, ds = trees
    G, D = port_nets(trees)
    z = np.random.default_rng(3).normal(size=(6, 100)).astype(np.float32)
    x = np.random.default_rng(4).uniform(-1, 1, (6,) + SMALL + (3,)).astype(np.float32)
    jg, jd = jsgan.Generator(n_upsamples=1), jsgan.Discriminator(n_classes=3, dropout_rate=0.0)
    want_g, gmut = jg.apply({"params": gp, "batch_stats": gs}, z, train=train,
                            mutable=["batch_stats"])
    want_d, dmut = jd.apply({"params": dp, "batch_stats": ds}, split(x), train=train,
                            mutable=["batch_stats"])
    got_g = G(torch.from_numpy(z), train=train)
    got_d = D(torch.from_numpy(x), train=train)
    for w, g in zip(want_g, got_g):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    np.testing.assert_allclose(got_d.detach().numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_d)).max())
    for net, mut in ((G, gmut), (D, dmut)):
        _, stats = sgan.sgan_params_to_numpy(net)
        for a, b in zip(leaves(stats), leaves(mut["batch_stats"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_generator_full_size_shapes_and_range():
    gen = sgan.Generator()
    (gp, gs), _ = sgan.sgan_init_trees(3, sgan.SGAN_RESCALE, seed=1)
    gen.load_state_dict(sgan.sgan_params_from_numpy(gp, gs))
    out = gen(torch.randn(2, 100, generator=torch.Generator().manual_seed(0)), train=False)
    for v in out:
        assert v.shape == (2, 128, 128, 1)
        assert float(v.abs().max()) <= 1.0


def test_heads_match_jax():
    logits = np.asarray([[0.0, 0.0, 0.0], [10.0, -10.0, 0.0], [0.3, 2.0, -1.0]], np.float32)
    t = torch.from_numpy(logits)
    np.testing.assert_allclose(sgan.custom_activation(t).numpy(),
                               np.asarray(jsgan.custom_activation(jnp.asarray(logits))),
                               rtol=1e-6)
    z = np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_allclose(sgan.d_head(t).numpy(), z / (z + 1.0), rtol=1e-6)
    np.testing.assert_allclose(sgan.c_head(t).numpy(),
                               np.asarray(jsgan.c_head(jnp.asarray(logits))), rtol=1e-6)


def jax_draws(key, half, full):
    """The draws of the JAX step for `key` (sgan_trainer.py's key splits),
    as the port's SGANDraws."""
    k = jax.random.split(key, 7)
    k_zf, k_zg, k_sm = k[4], k[5], k[6]

    def t(a):
        return torch.from_numpy(np.array(a))

    return st.SGANDraws(
        y_real=t(1.0 - 0.3 + jax.random.uniform(k_sm, (half, 1)) * 0.5),
        z_fake=t(jax.random.normal(k_zf, (half, 100))),
        y_fake=t(jax.random.uniform(jax.random.fold_in(k_sm, 1), (half, 1)) * 0.3),
        z_gan=t(jax.random.normal(k_zg, (full, 100))),
        y_gan=t(1.0 - 0.3 + jax.random.uniform(jax.random.fold_in(k_sm, 2), (full, 1)) * 0.5),
        masks=(None,) * 4)


def moments(opt, module, key):
    return sgan.sgan_params_to_numpy(
        {n: opt.state[p][key] for n, p in module.named_parameters()})[0]


def frac(got, want, atol):
    """The share of elements of two trees within atol + 1e-3·|want|."""
    close = total = 0
    for a, b in zip(leaves(got), leaves(want)):
        close += int((np.abs(a - b) <= atol + 1e-3 * np.abs(b)).sum())
        total += a.size
    return close / total


def jax_steps(trees, n_steps, nudge=False):
    """n_steps of the JAX step from `trees` (moved one float32 ulp up with
    `nudge`): (state, losses per step, the inputs and keys used)."""
    gp, gs, dp, ds = trees
    if nudge:
        gp, dp = (jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), t)
                  for t in (gp, dp))
    cfg = jst.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, seed=0)
    jstep = jst.make_sgan_step(jsgan.Generator(n_upsamples=1),
                               jsgan.Discriminator(n_classes=3, dropout_rate=0.0), cfg,
                               real_weight=1.3)
    adam = optax.adam(LR, b1=0.5, eps=1e-7)
    js = jst.SGANState(gp, gs, dp, ds, adam.init(dp), adam.init(dp), adam.init((gp, dp)))
    rng = np.random.default_rng(0)
    inputs, losses = [], []
    for s in range(n_steps):
        sv = rng.normal(size=(4,) + SMALL + (3,)).astype(np.float32)
        sl = np.array([0, 1, 2, 0])
        rv = rng.normal(size=(4,) + SMALL + (3,)).astype(np.float32)
        key = jax.random.PRNGKey(10 + s)
        js, jl = jstep(js, jnp.asarray(sv), jnp.asarray(sl, jnp.int32), jnp.asarray(rv), key)
        inputs.append((sv, sl, rv, key))
        losses.append({k: float(v) for k, v in jl.items()})
    return js, losses, inputs


def comparable(js, G, D, state):
    """Pairs (name, port tree, JAX tree, atol) of everything the step
    updates: both networks' parameters and statistics, and the three Adam
    states' moments."""
    (pgp, pgs), (pdp, pds) = sgan.sgan_params_to_numpy(G), sgan.sgan_params_to_numpy(D)
    out = [("g_params", pgp, js.g_params, 1e-5), ("d_params", pdp, js.d_params, 1e-5),
           ("g_stats", pgs, js.g_stats, 1e-5), ("d_stats", pds, js.d_stats, 1e-5)]
    for name, jopt, popt, nets in (("c", js.c_opt, state.c_opt, [D]),
                                   ("d", js.d_opt, state.d_opt, [D]),
                                   ("gan", js.gan_opt, state.gan_opt, [G, D])):
        adam_state = jopt[0]
        steps = {float(popt.state[p]["step"]) for p in popt.state}
        assert steps == {float(adam_state.count)}, name
        for i, net in enumerate(nets):
            jmu = adam_state.mu[i] if name == "gan" else adam_state.mu
            jnu = adam_state.nu[i] if name == "gan" else adam_state.nu
            out += [(f"{name}{i}_mu", moments(popt, net, "exp_avg"), jmu, 1e-6),
                    (f"{name}{i}_nu", moments(popt, net, "exp_avg_sq"), jnu, 1e-10)]
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_fused_steps_match_jax(trees, n_steps):
    js, jlosses, inputs = jax_steps(trees, n_steps)
    G, D = port_nets(trees)
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, seed=0)
    state = st.make_state(G, D, cfg)
    pstep = st.make_sgan_step(G, D, cfg, real_weight=1.3)
    for (sv, sl, rv, key), jl in zip(inputs, jlosses):
        state, pl = pstep(state, torch.from_numpy(sv), torch.from_numpy(sl),
                          torch.from_numpy(rv), jax_draws(key, 4, 8))
        for k in jl:
            np.testing.assert_allclose(float(pl[k]), jl[k],
                                       rtol=1e-5 if n_steps == 1 else 1e-4, err_msg=k)
    # Adam updates per step: the generator's one (gan), the discriminator's four
    (pgp, _), (pdp, _) = sgan.sgan_params_to_numpy(G), sgan.sgan_params_to_numpy(D)
    for got, want, updates in ((pgp, js.g_params, 1), (pdp, js.d_params, 4)):
        for a, b in zip(leaves(got), leaves(want)):
            assert np.abs(a - b).max() <= 2 * LR * updates * n_steps * (1 + 1e-3)
    pairs = comparable(js, G, D, state)
    if n_steps == 1:
        bars = {name: (0.995 if "params" in name else 0.99) for name, *_ in pairs}
        bars["g_stats"] = bars["d_stats"] = 1.0
    else:
        # JAX's own spread: the same three steps from weights one ulp up
        jnudged, _, _ = jax_steps(trees, n_steps, nudge=True)
        spread = comparable(jnudged, G, D, state)
        bars = {name: frac(jtree, want, atol)
                for (name, _, want, atol), (_, _, jtree, _) in zip(pairs, spread)}
    for name, got, want, atol in pairs:
        got_frac = frac(got, want, atol)
        if n_steps == 1:
            assert got_frac >= bars[name], (name, got_frac, bars[name])
        else:  # at most twice JAX's own disagreeing share, plus 1e-4
            assert 1 - got_frac <= 2 * (1 - bars[name]) + 1e-4, (name, got_frac, bars[name])


def test_gan_phase_freezes_non_bn_disc_params(trees):
    """With the c and d phases at learning rate 0, one step moves the
    generator and the discriminator's BatchNorm scale/bias only; every
    other discriminator parameter is bit-identical, and the GAN Adam's
    moments of those parameters stay zero."""
    G, D = port_nets(trees, dropout_rate=0.5)
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, seed=0)
    state = st.make_state(G, D, cfg)
    for opt in (state.c_opt, state.d_opt):
        for group in opt.param_groups:
            group["lr"] = 0.0
    before = {n: p.detach().clone() for n, p in D.named_parameters()}
    g_before = {n: p.detach().clone() for n, p in G.named_parameters()}
    step = st.make_sgan_step(G, D, cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4,) + SMALL + (3,))
                         .astype(np.float32))
    draws = st.draw_step(cfg, 4, D, torch.Generator().manual_seed(0))
    assert draws.masks[0] is not None  # dropout live in every phase
    step(state, x, torch.tensor([0, 1, 2, 0]), x, draws)
    bn = st._bn_params(D)
    assert bn and all("BatchNorm" in n for n in bn)
    for n, p in D.named_parameters():
        if n in bn:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
            assert not state.gan_opt.state[p]["exp_avg"].any()
    assert any(not torch.equal(p, g_before[n]) for n, p in G.named_parameters())


def test_select_supervised_samples_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 4, 4, 3)).astype(np.float32)
    y = np.arange(30) % 3
    sup = np.ones(30, bool)
    sup[y == 2] = False
    sup[[2, 5]] = True  # only two supervised class-2 samples
    jX, jy = jst.select_supervised_samples(X, y, sup, 9, 3, np.random.default_rng(4))
    tX, ty = st.select_supervised_samples(torch.from_numpy(X), y, sup, 9, 3,
                                          np.random.default_rng(4))
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    assert (np.bincount(ty) == 3).all()
    with pytest.raises(ValueError):
        st.select_supervised_samples(X, y, np.zeros(30, bool), 9, 3, rng)


def test_pooled_stats_match_jax(trees):
    gp, gs, dp, ds = trees
    G, D = port_nets(trees)
    X = np.random.default_rng(3).normal(size=(32,) + SMALL + (3,)).astype(np.float32)
    batches = X.reshape((2, 16) + SMALL + (3,))
    jd = jsgan.Discriminator(n_classes=3)
    want = jst._recal_fn(jd)(dp, ds, jnp.asarray(batches))
    got = sgan.sgan_params_to_numpy(st.pooled_disc_stats(D, torch.from_numpy(batches)))[1]
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # the module's own running statistics are untouched
    for a, b in zip(leaves(sgan.sgan_params_to_numpy(D)[1]), leaves(ds)):
        np.testing.assert_array_equal(a, b)
    zs = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (3, 8, 100)))
    jg = jsgan.Generator(n_upsamples=1)
    want = jst._gen_recal_fn(jg)(gp, gs, jnp.asarray(zs))
    got = sgan.sgan_params_to_numpy(st.pooled_gen_stats(G, torch.from_numpy(zs)))[1]
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_recalibrate_bn_stats_matches_jax_and_population_forward(trees):
    gp, gs, dp, ds = trees
    G, D = port_nets(trees)
    X = np.random.default_rng(3).normal(size=(24,) + SMALL + (3,)).astype(np.float32)
    jd = jsgan.Discriminator(n_classes=3)
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9)
    jstate = jst.SGANState(gp, gs, dp, ds, None, None, None)
    want = jst.recalibrate_bn_stats(jd, jstate, X, batch=8, n_passes=3, seed=7).d_stats
    state = st.make_state(G, D, cfg)
    st.recalibrate_bn_stats(D, state, X, batch=8, n_passes=3, seed=7)
    for a, b in zip(leaves(sgan.sgan_params_to_numpy(D)[1]), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # one pass over the whole set: eval mode then equals the train-mode
    # (batch-stat, dropout-off) forward on that set
    Xt = torch.from_numpy(X)
    train_logits = D(Xt, train=True).detach()
    G2, D2 = port_nets(trees)
    D2.load_state_dict(st.pooled_disc_stats(D2, Xt[None]), strict=False)
    torch.testing.assert_close(D2(Xt, train=False), train_logits, rtol=1e-4, atol=1e-4)
    z = torch.randn(16, 100, generator=torch.Generator().manual_seed(5))
    G2.load_state_dict(st.pooled_gen_stats(G2, z[None]), strict=False)
    G3, _ = port_nets(trees)
    for a, b in zip(G2(z, train=False), G3(z, train=True)):
        torch.testing.assert_close(a, b.detach(), rtol=1e-4, atol=1e-4)
    out = st.recalibrate_gen_stats(G, state, torch.Generator().manual_seed(6), 100,
                                   batch=8, n_passes=2)
    assert out is state


def small_run_data(n=24, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n,) + SMALL + (3,)).astype(np.float32) * 0.5
    y = (np.arange(n) % 3).astype(np.int64)
    return X, y


def test_train_sgan_short_run_and_fake_dataset(tmp_path):
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, seed=0, n_epochs=1)
    gen, disc, state = st.sgan_init(cfg, SMALL, device="cpu")
    X, y = small_run_data()
    accs = []
    state = st.train_sgan(gen, disc, state, (X, y, None), (X[:12], y[:12]), cfg,
                          results_dir=str(tmp_path),
                          on_summary=lambda i, acc, s: accs.append(acc))
    assert accs and 0.0 <= accs[-1] <= 1.0
    pickles = list(tmp_path.glob("generated_data_*.pickle"))
    assert pickles
    import pickle as pkl

    with open(pickles[0], "rb") as fp:
        data = pkl.load(fp)
    assert len(data["samples"]) == 100
    xz, yz, xy = data["samples"][0]
    assert xz.shape == (22, 176) and yz.shape == (31, 176) and xy.shape == (22, 31)
    assert data["labels"][0] == "generated_data"
    with open(next(tmp_path.glob("sgan_state_*.pickle")), "rb") as fp:
        snap = pkl.load(fp)
    assert set(snap) == {"g_params", "g_stats", "d_params", "d_stats"}
    fake = st.generate_fake_dataset(gen, 3, torch.Generator().manual_seed(0))
    assert len(fake["samples"]) == 3
    assert all(np.isfinite(p).all() for s in fake["samples"] for p in s)


def test_sgan_resume_continues_mid_run(tmp_path):
    """The port of tests/test_checkpoint.py's SGAN case: train 1 epoch with
    checkpoints, then resume: the second call restores the saved step,
    runs only the remainder, and ends where an uninterrupted run ends."""
    cfg = st.SGANConfig(n_classes=3, n_batch=8, n_sup_samples=9, n_epochs=2, seed=0)
    X, y = small_run_data(16)  # bat_per_epo = 2 → 4 steps, checkpoint every 2
    ck = str(tmp_path / "ck")
    gen, disc, state = st.sgan_init(dataclasses.replace(cfg, n_epochs=1), SMALL, device="cpu")
    st.train_sgan(gen, disc, state, (X, y, None), (X[:8], y[:8]),
                  dataclasses.replace(cfg, n_epochs=1), checkpoint_dir=ck)
    assert CheckpointStore(ck).latest_step() == 2

    seen = []
    gen, disc, state = st.sgan_init(cfg, SMALL, device="cpu")
    st.train_sgan(gen, disc, state, (X, y, None), (X[:8], y[:8]), cfg, checkpoint_dir=ck,
                  resume=True, on_summary=lambda i, acc, s: seen.append(i))
    assert seen == [3]  # resumed at step 2: only the step-4 summary fires
    assert CheckpointStore(ck).latest_step() == 4

    g2, d2, s2 = st.sgan_init(cfg, SMALL, device="cpu")
    st.train_sgan(g2, d2, s2, (X, y, None), (X[:8], y[:8]), cfg)
    for a, b in zip(disc.state_dict().values(), d2.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(gen.state_dict().values(), g2.state_dict().values()):
        assert torch.equal(a, b)


def test_sgan_init_rejects_bad_rescale_and_mesh():
    cfg = st.SGANConfig()
    with pytest.raises(ValueError):
        st.sgan_init(cfg, (24, 24), device="cpu")
    with pytest.raises(ValueError):
        st.sgan_init(cfg, (16, 32), device="cpu")
    gen, disc, _ = st.sgan_init(cfg, SMALL, device="cpu")
    # the sharded step is ported (tests/test_torch_mesh_train.py); anything
    # but a parallel.mesh.Mesh is refused
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        st.make_sgan_step(gen, disc, cfg, mesh=object())

"""The port's multi-device layer (radarml_tpu_torch/parallel) against
tests/test_parallel.py's cases and the JAX package's step.

The JAX runs use the 8-virtual-device CPU mesh of tests/conftest.py; the
port's multi-rank runs start gloo ranks on the CPU, each a process that
runs a driver script written to tmp_path and imports only torch and the
port. Each group of ranks runs once per module and several tests read
its results; every group has a deadline.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarml_tpu.parallel.mesh import replicate as jax_replicate
from radarml_tpu.parallel.mesh import shard_batch as jax_shard_batch
from radarml_tpu.parallel.train_step import make_dp_sgd_train_step as jax_dp_step
from radarml_tpu_torch.parallel import mesh as tmesh
from radarml_tpu_torch.parallel.spawn import RanksFailed, run_ranks
from radarml_tpu_torch.parallel.train_step import make_dp_sgd_train_step

CPU = "cpu"
RANK_TIMEOUT = 120

_COMMON = r'''
import json, os, sys
import numpy as np
import torch
from radarml_tpu_torch.parallel import mesh as tmesh
from radarml_tpu_torch.parallel.train_step import make_dp_sgd_train_step
torch.set_num_threads(1)  # the suite's other workers share the host
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out_dir = sys.argv[1]

def dump(name, **arrays):
    np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})

def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None
'''

# Two ranks joined with an explicit coordinator address (the JAX DCN case).
_TWO_RANKS = _COMMON + r'''
addr = f"127.0.0.1:{os.environ['MASTER_PORT']}"
tmesh.init_distributed(addr, world, rank, device="cpu")
tmesh.init_distributed(addr, world, rank, device="cpu")  # idempotent
mesh = tmesh.make_mesh(device="cpu")
report = {"size": mesh.size, "backend": mesh.backend, "rank": mesh.rank,
          "shape": list(mesh.shape), "device": str(mesh.device)}

# the DCN case: each process passes its own slice of the global batch
rng = np.random.default_rng(0)
X = rng.normal(size=(16, 12)).astype(np.float32)
y = (np.arange(16) % 3).astype(np.int64)
lo = slice(rank * 8, (rank + 1) * 8)
Xg, yg = tmesh.local_to_global(mesh, X[lo], y[lo])
params = tmesh.replicate(mesh, {"coef": np.zeros((3, 12), np.float32),
                                "intercept": np.zeros(3, np.float32)})
step = make_dp_sgd_train_step(mesh, n_classes=3, lr=0.5)
for _ in range(3):
    params, loss = step(params, Xg, yg)
dump("dcn", coef=params["coef"], intercept=params["intercept"], loss=loss)

# tests/test_parallel.py::test_dp_matches_single_device, on shard_batch
rng = np.random.default_rng(1)
X = rng.normal(size=(32, 16)).astype(np.float32)
y = rng.integers(0, 3, 32)
Xs, ys = tmesh.shard_batch(mesh, X, y)
report["shard_rows"] = [int(Xs.shape[0]), float(Xs[0, 0])]
params = tmesh.replicate(mesh, {"coef": torch.zeros(3, 16), "intercept": torch.zeros(3)})
step = make_dp_sgd_train_step(mesh, n_classes=3, lr=0.1, weight_decay=1e-3)
for _ in range(5):
    params, loss = step(params, Xs, ys)
dump("dp", coef=params["coef"], intercept=params["intercept"], loss=loss)

# replicate broadcasts the first rank's values
rep = tmesh.replicate(mesh, [torch.full((2,), float(rank))])
report["replicated"] = rep[0].tolist()
report["gathered"] = tmesh.gather_batch(mesh, torch.full((1, 2), float(rank))).tolist()
report["odd_batch"] = raises(lambda: tmesh.shard_batch(mesh, np.zeros((5, 2))))
report["uneven_local"] = raises(lambda: tmesh.local_to_global(mesh, np.zeros((2 + rank, 2))))

# the predictor sharded in fast mode (tests/test_parallel.py)
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
from radarml_tpu_torch.models.pipeline import RadarPredictor
rng = np.random.default_rng(1234)
C, F = 3, DEFAULT_ARENA.feature_length
model = LinearModel(coef=torch.as_tensor(rng.normal(size=(C, F)) * 0.01, dtype=torch.float32),
                    intercept=torch.zeros(C))
calib = SigmoidCalibration(a=-torch.ones(C), b=torch.zeros(C))
pred = RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
                      calibration=calib, min_proba=0.5, mode="fast", mesh=mesh)
cubes = (rng.random((16,) + DEFAULT_ARENA.grid_shape) * 255).astype(np.float32)
xyz = rng.uniform(-20, 20, size=(16, 2, 3)).astype(np.float32)
xyz[..., 2] = np.abs(xyz[..., 2]) + 60.0
valid = np.ones((16, 2), bool)
p, best, proba = pred(cubes, xyz, valid)
dump("fast", cubes=cubes, xyz=xyz, coef=model.coef, pred=p, proba=proba)
report["odd_scans"] = raises(lambda: pred(cubes[:5], xyz[:5], valid[:5]))
print(json.dumps(report))
tmesh.close_distributed()
'''

# Four ranks from the environment, as torchrun starts them.
_FOUR_RANKS = _COMMON + r'''
tmesh.init_distributed(device="cpu")
flat = tmesh.make_mesh(device="cpu")
mesh = tmesh.make_mesh(4, shape=(2, 2), axis_names=("data", "model"), device="cpu")
X = np.arange(8, dtype=np.float32)[:, None]
x = tmesh.shard_batch(mesh, X)
report = {
    "flat": [list(flat.shape), list(flat.axis_names), flat.data_size, flat.data_rank],
    "mesh": [list(mesh.shape), list(mesh.axis_names), mesh.data_size, mesh.data_rank],
    "rows": x[:, 0].tolist(),
    "summed": mesh.all_reduce_(torch.ones(1)).tolist(),
    "gathered": mesh.all_gather(x)[:, 0].tolist(),
    "padded": list(tmesh.make_mesh(4, shape=(2, 2), device="cpu").axis_names),
    "too_many": raises(lambda: tmesh.make_mesh(5, device="cpu")),
    "bad_shape": raises(lambda: tmesh.make_mesh(4, shape=(3, 2), device="cpu")),
    "part_of_group": raises(lambda: tmesh.make_mesh(2, device="cpu")),
    "one": [tmesh.make_mesh(1, device="cpu").backend, tmesh.make_mesh(1).data_size],
}
print(json.dumps(report))
tmesh.close_distributed()
'''


def _launch(tmp_path_factory, name, src, n):
    out = tmp_path_factory.mktemp(name)
    driver = out / "driver.py"
    driver.write_text(src)
    stdout = run_ranks([sys.executable, str(driver), str(out)], n, RANK_TIMEOUT)
    reports = [json.loads(s.strip().splitlines()[-1]) for s in stdout]
    return out, reports


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch(tmp_path_factory, "two", _TWO_RANKS, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch(tmp_path_factory, "four", _FOUR_RANKS, 4)


def _zeros(c, f):
    return {"coef": torch.zeros(c, f), "intercept": torch.zeros(c)}


def test_make_mesh_shapes(four):
    _, reports = four
    for r, rep in enumerate(reports):
        assert rep["flat"] == [[4], ["data"], 4, r]
        assert rep["mesh"][:3] == [[2, 2], ["data", "model"], 2]
        assert rep["mesh"][3] == r // 2  # row-major: data is the slow axis
        assert rep["rows"] == list(np.arange(8)[r // 2 * 4:(r // 2 + 1) * 4])
        assert rep["summed"] == [2.0]  # over the data axis only
        assert rep["gathered"] == list(range(8))
        assert rep["padded"] == ["data", "axis1"]
        assert rep["one"] == ["local", 1]


def test_make_mesh_value_errors(four):
    _, reports = four
    for rep in reports:
        assert "only 4 available" in rep["too_many"]
        assert "(3, 2) != 4" in rep["bad_shape"]
        assert "--nproc-per-node 2" in rep["part_of_group"]
    with pytest.raises(ValueError, match="only 1 available"):
        tmesh.make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match=r"\(2,\) != 1"):
        tmesh.make_mesh(1, shape=(2,), device=CPU)
    assert tmesh.make_mesh(1, shape=(1, 1), device=CPU).axis_names == ("data", "axis1")


def test_init_distributed_twice_and_the_group(two):
    _, reports = two
    for r, rep in enumerate(reports):
        assert (rep["size"], rep["backend"], rep["rank"]) == (2, "gloo", r)
        assert rep["device"] == "cpu"
        assert rep["replicated"] == [0.0, 0.0]
        assert rep["gathered"] == [[0.0, 0.0], [1.0, 1.0]]
        assert rep["shard_rows"][0] == 16
        assert "divisible" in rep["odd_batch"]
        assert "differ" in rep["uneven_local"]
        assert "divisible" in rep["odd_scans"]


def test_one_rank_mesh_is_local_and_bit_equal():
    mesh = tmesh.make_mesh(1, device=CPU)
    assert (mesh.backend, mesh.size, mesh.device) == ("local", 1, torch.device("cpu"))
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.normal(size=(24, 10)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 3, 24))
    a = b = _zeros(3, 10)
    step_a = make_dp_sgd_train_step(None, 3, lr=0.2, weight_decay=1e-2)
    step_b = make_dp_sgd_train_step(mesh, 3, lr=0.2, weight_decay=1e-2)
    for _ in range(4):
        a, la = step_a(a, X, y)
        b, lb = step_b(b, X, y)
    assert torch.equal(a["coef"], b["coef"]) and torch.equal(la, lb)
    assert torch.equal(tmesh.shard_batch(mesh, X), X)


def test_dp_train_step_runs_and_learns():
    mesh = tmesh.make_mesh(1, device=CPU)
    rng = np.random.default_rng(0)
    n, f, c = 64, 32, 3
    true_w = rng.normal(size=(c, f))
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X @ true_w.T).argmax(1)
    params = tmesh.replicate(mesh, _zeros(c, f))
    Xs, ys = tmesh.shard_batch(mesh, X, y)
    step = make_dp_sgd_train_step(mesh, n_classes=c, lr=0.5)
    losses = []
    for _ in range(60):
        params, loss = step(params, Xs, ys)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.3


def _single_dp(X, y, c, lr, wd, steps):
    params = _zeros(c, X.shape[1])
    step = make_dp_sgd_train_step(None, c, lr=lr, weight_decay=wd)
    for _ in range(steps):
        params, loss = step(params, torch.as_tensor(X), torch.as_tensor(y))
    return params, loss


def test_dp_two_ranks_match_one_rank(two):
    out, _ = two
    rng = np.random.default_rng(1)
    X = rng.normal(size=(32, 16)).astype(np.float32)
    y = rng.integers(0, 3, 32)
    p1, l1 = _single_dp(X, y, 3, 0.1, 1e-3, 5)
    r0, r1 = (np.load(out / f"dp_r{r}.npz") for r in range(2))
    np.testing.assert_array_equal(r0["coef"], r1["coef"])  # replicas agree
    np.testing.assert_allclose(r0["coef"], p1["coef"].numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["intercept"], p1["intercept"].numpy(), atol=1e-5)
    np.testing.assert_allclose(float(r0["loss"]), float(l1), rtol=1e-5)


def test_dp_step_matches_jax(two):
    """The port's step (one rank and two) against JAX's on the 8-device
    mesh: same init and data, 5 steps, atol 1e-5."""
    out, _ = two
    rng = np.random.default_rng(1)
    X = rng.normal(size=(32, 16)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    mesh8 = jax_make_mesh(8)
    jp = jax_replicate(mesh8, {"coef": jnp.zeros((3, 16)), "intercept": jnp.zeros((3,))})
    X8, y8 = jax_shard_batch(mesh8, X, y)
    jstep = jax_dp_step(mesh8, n_classes=3, lr=0.1, weight_decay=1e-3)
    for _ in range(5):
        jp, jl = jstep(jp, X8, y8)
    p1, l1 = _single_dp(X, y.astype(np.int64), 3, 0.1, 1e-3, 5)
    r0 = np.load(out / "dp_r0.npz")
    for got in (p1["coef"].numpy(), r0["coef"]):
        np.testing.assert_allclose(got, np.asarray(jp["coef"]), atol=1e-5)
    np.testing.assert_allclose(r0["intercept"], np.asarray(jp["intercept"]), atol=1e-5)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)


def test_multiprocess_local_to_global_dp_step(two):
    """Two processes, each with its own half: the gradient sum crosses the
    process boundary and matches one process on the whole batch and the
    JAX 8-device run to reduction-order tolerance."""
    out, _ = two
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16, 12)).astype(np.float32)
    y = (np.arange(16) % 3).astype(np.int64)
    p1, _ = _single_dp(X, y, 3, 0.5, 0.0, 3)
    mesh8 = jax_make_mesh(8)
    Xs, ys = jax_shard_batch(mesh8, X, y.astype(np.int32))
    jp = jax_replicate(mesh8, {"coef": jnp.zeros((3, 12), jnp.float32),
                               "intercept": jnp.zeros((3,), jnp.float32)})
    jstep = jax_dp_step(mesh8, n_classes=3, lr=0.5)
    for _ in range(3):
        jp, _ = jstep(jp, Xs, ys)
    for r in range(2):
        got = np.load(out / f"dcn_r{r}.npz")
        for want in (p1["coef"].numpy(), np.asarray(jp["coef"])):
            np.testing.assert_allclose(got["coef"], want, atol=1e-6)
        np.testing.assert_allclose(got["intercept"], np.asarray(jp["intercept"]), atol=1e-6)
        assert np.isfinite(got["loss"])


def test_predictor_shards_over_mesh(two):
    """Batched fast-mode predict with the scans sharded over two ranks
    equals the single call (and JAX's fast mode on its mesh)."""
    from radarml_tpu.core.arena import DEFAULT_ARENA as JA
    from radarml_tpu.models.linear import LinearModel as JLM, SigmoidCalibration as JSC
    from radarml_tpu.models.pipeline import RadarPredictor as JRP
    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.models.linear import LinearModel, SigmoidCalibration
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    out, _ = two
    r0, r1 = (np.load(out / f"fast_r{r}.npz") for r in range(2))
    np.testing.assert_array_equal(r0["proba"], r1["proba"])  # every rank has it all
    C = 3
    single = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, mode="fast", min_proba=0.5,
        model=LinearModel(coef=torch.as_tensor(r0["coef"]), intercept=torch.zeros(C)),
        calibration=SigmoidCalibration(a=-torch.ones(C), b=torch.zeros(C)))
    p1, _, proba1 = single(r0["cubes"], r0["xyz"], np.ones((16, 2), bool))
    np.testing.assert_array_equal(r0["pred"], p1.numpy())
    np.testing.assert_allclose(r0["proba"], proba1.numpy(), atol=1e-6)
    jax_pred = JRP(mode="fast", mesh=jax_make_mesh(8), train_arena=JA, scan_arena=JA,
                   min_proba=0.5,
                   model=JLM(coef=jnp.asarray(r0["coef"]), intercept=jnp.zeros((C,))),
                   calibration=JSC(a=-jnp.ones((C,)), b=jnp.zeros((C,))))
    pj, _, probaj = jax_pred(jnp.asarray(r0["cubes"]), jnp.asarray(r0["xyz"]),
                             jnp.ones((16, 2), bool))
    np.testing.assert_array_equal(r0["pred"], np.asarray(pj))
    np.testing.assert_allclose(r0["proba"], np.asarray(probaj), atol=1e-6)


def test_placements_and_check_mesh():
    mesh = tmesh.make_mesh(1, shape=(1, 1), axis_names=("data", "model"), device=CPU)
    assert [str(p) for p in tmesh.batch_sharding(mesh)] == ["S(0)", "R"]
    assert [str(p) for p in tmesh.replicated(mesh)] == ["R", "R"]
    assert tmesh.check_mesh(mesh) is mesh and tmesh.check_mesh(None) is None
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tmesh.check_mesh(jax.devices())


# Leaving the group: close_distributed before a group, twice after it, and
# the group's store as run_ranks hosts it.
_CLOSE = r'''
import json, os, sys
import torch
import torch.distributed as dist
from radarml_tpu_torch.parallel import mesh as tmesh
tmesh.close_distributed()  # no group yet: nothing to do
tmesh.init_distributed(device="cpu")
tag = int(sys.argv[1])
t = torch.tensor([10.0 * tag + dist.get_rank()])
dist.all_reduce(t)
report = {"sum": t.item(), "port": os.environ["MASTER_PORT"], "rank": dist.get_rank()}
if sys.argv[2] == "raise" and dist.get_rank() == 1:
    raise RuntimeError("rank 1 fails after joining")
if sys.argv[2] == "close":
    tmesh.close_distributed()
    tmesh.close_distributed()  # idempotent
    report["after"] = dist.is_initialized()
print(json.dumps(report))
'''


def _close_group(tmp_path, tag, how):
    driver = tmp_path / f"close_{tag}.py"
    driver.write_text(_CLOSE)
    outs = run_ranks([sys.executable, str(driver), str(tag), how], 2, RANK_TIMEOUT)
    return [json.loads(s.strip().splitlines()[-1]) for s in outs]


def test_close_distributed_is_idempotent_and_ranks_exit_0(tmp_path):
    """A rank program that leaves its group (twice) exits 0, as does one
    that leaves it through the exit handler init_distributed registers;
    with no group, close_distributed does nothing."""
    tmesh.close_distributed()
    assert not torch.distributed.is_initialized()
    for how in ("close", "at_exit"):
        reports = _close_group(tmp_path, 1, how)  # returns: every rank exited 0
        assert [r["sum"] for r in reports] == [21.0, 21.0]
        if how == "close":
            assert [r["after"] for r in reports] == [False, False]


def test_a_failing_rank_still_fails_the_group(tmp_path):
    """The exit handler skips its barrier after an uncaught exception, so
    the failing rank exits non-zero at once and run_ranks raises."""
    with pytest.raises(RanksFailed, match=r"(?s)rank 1 of 2: exit code 1.*fails after joining"):
        _close_group(tmp_path, 2, "raise")


def test_concurrent_groups_get_their_own_store(tmp_path):
    """Two groups started at once: each rank joins its own group's store
    (a port per group) and sums its own group's values."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(lambda tag: _close_group(tmp_path, tag, "close"), (3, 4)))
    a, b = got
    assert [r["sum"] for r in a] == [61.0, 61.0] and [r["sum"] for r in b] == [81.0, 81.0]
    assert len({r["port"] for r in a}) == 1 and len({r["port"] for r in b}) == 1
    assert a[0]["port"] != b[0]["port"]

"""The fast modes' table routes on the card (models/pipeline.py).

`folded_tables` computes M1 in one product at a small batch and one
product a x past `pipeline.M1_SLAB_BYTES` of one x's slab; `exact_tables`
computes m1 and m3 over the batch's (scan, x) blocks at a small batch
and a x past `pipeline.EXACT_BLOCK_BYTES` of the bytes those products
move. On the
card: the int8 route's integers equal the float64 einsums' under both
routes and at batches on each side of its budget, at the default arena
and at 43 x 31 x 351; an exported fast float32 predictor (symbolic batch,
`torch.cond` choosing the route at each call) gives the live predictor's
bits on each side of its budget, on the card and in its CPU program, and
so does an exported fast int8 one. The
file imports no JAX, so on the card it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fast_routes_card.py
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.models import linear as tl
from radarml_tpu_torch.models import pipeline as tp

SPECS = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")
ARENAS = {"22x31x176": DEFAULT_ARENA.grid_shape,
          "43x31x351": Arena(r_res=1.0, theta_res=2.0).grid_shape}
ROWS = 6  # int8 template rows a plane (3 classes)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edge():
    """The last batch of the float32 route's one product at the default
    arena, and the next."""
    _, Y, Z = DEFAULT_ARENA.grid_shape
    n = tp.M1_SLAB_BYTES // (4 * Y * Z)
    return n, n + 1


def _exact_edge(dims):
    """The int8 route's last block batch at 3 classes, and the next."""
    X, Y, Z = dims
    n = tp.EXACT_BLOCK_BYTES // (2 * 4 * X * (Y * Z + (Y + Z) * ROWS))
    return n, n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, "last", "next"])
@pytest.mark.parametrize("arena", list(ARENAS))
def test_exact_tables_equal_float64_einsums_on_card(arena, B):
    dev = _card()
    X, Y, Z = dims = ARENAS[arena]
    if isinstance(B, str):
        B = _exact_edge(dims)[B == "next"]
    assert tp.block_products_exact((B,) + dims, [ROWS, ROWS]) == (B <= _exact_edge(dims)[0])
    gen = torch.Generator(device=dev).manual_seed(B)
    cube = torch.randint(-128, 128, (B, X, Y, Z), generator=gen, device=dev, dtype=torch.int8)
    quant = [torch.randint(-127, 128, s, generator=gen, device=dev, dtype=torch.int8)
             for s in ((ROWS, X, Z), (ROWS, Y, Z), (ROWS, X, Y))]
    v = cube.to(torch.float64)
    want = [torch.einsum(s, q.to(torch.float64), v).to(torch.int64) for s, q in zip(SPECS, quant)]
    for budget in (tp.EXACT_BLOCK_BYTES, 1 << 62, 0):
        tp.EXACT_BLOCK_BYTES, kept = budget, tp.EXACT_BLOCK_BYTES
        try:
            got = tp.folded_tables_exact(cube, quant)
        finally:
            tp.EXACT_BLOCK_BYTES = kept
        for g, w, s in zip(got, want, SPECS):
            assert torch.equal(g, w), (s, budget)


@pytest.mark.cuda
@pytest.mark.parametrize("cube_dtype", ["float32", "int8"])
def test_exported_fast_predictor_keeps_the_live_bits_on_card(tmp_path, cube_dtype):
    from radarml_tpu_torch.serving import export_predictor, load_serving_artifact

    dev = _card()
    rng = np.random.default_rng(0)
    C, F = 3, DEFAULT_ARENA.feature_length
    weights = ((rng.normal(size=(C, F)) * 0.01).astype(np.float32), np.zeros(C, np.float32),
               -np.ones(C, np.float32), np.zeros(C, np.float32))

    def predictor(device):
        model, calib = tl.from_numpy(*weights, device=device)
        return tp.RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
                                 model=model, calibration=calib, mode="fast",
                                 cube_dtype=cube_dtype, device=device)

    live = {"cuda": predictor(dev), "cpu": predictor("cpu")}
    path = str(tmp_path / "fast.rmlx")
    export_predictor(live["cuda"], path, max_targets=2, platforms=("cuda", "cpu"))
    arts = {d: load_serving_artifact(path, device=d) for d in live}
    edge = _edge() if cube_dtype == "float32" else _exact_edge(DEFAULT_ARENA.grid_shape)
    for B in (1, 7, *edge):
        cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(np.float32)
        xyz, valid = tp.pad_targets([[(1.0, -2.0, 90.0), (4.0, 3.0, 140.0)]] * B, max_targets=2)
        for d in live:  # each program against the live predictor on its device
            want, got = live[d](cubes, xyz, valid), arts[d](cubes, xyz, valid)
            for w, g in zip(want, got):
                assert torch.equal(w.cpu(), g.cpu()), (B, d)

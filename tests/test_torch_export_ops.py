"""The port's serving programs, unsafe archives and kernels as torch ops.

* A program whose archive carries a pickle with a __reduce__ payload, where
  torch.export.load would run it with the full unpickler, is refused with
  ValueError and the payload never runs; so is one that names its sample
  inputs twice, a harmless entry beside the payload in either order (the
  two zip readers pick different entries of a repeated name).
* Each kernel's CUDA implementation refuses, before any launch, operands
  that the kernel could not read by pointer (a permuted cube or slot
  tensor): an exported program calls it with no wrapper in front.
* Each of the seven kernels is a torch op (ops/library.py) that passes
  torch.library.opcheck on the CPU, whose fake shapes and dtypes are its
  real outputs', and whose CPU output is its plain version's, bit for bit.
* An exported SVC program runs the coupling loop in full (a traced
  while_loop of max_iter iterations); that gives the early-stopped loop's
  bits, and its artifact equals the live predictor.
"""

import io
import json
import warnings
import zipfile

import numpy as np
import pytest
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import svc as tsvc
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.ops import i8_score, i8_tails, library, rbf, score
from radarml_tpu_torch.serving import export_predictor, load_serving_artifact
from radarml_tpu_torch.serving.export import _SAMPLE_INPUTS, MAGIC

torch.set_num_threads(1)


def _equal(live, got):
    for w, g in zip(live, got):
        assert torch.equal(torch.as_tensor(w), torch.as_tensor(g))


@pytest.fixture(scope="module")
def predictor():
    rng = np.random.default_rng(0)
    C, F = 3, DEFAULT_ARENA.feature_length
    model, calib = tlin.from_numpy((rng.normal(size=(C, F)) * 0.01).astype(np.float32),
                                   np.zeros(C, np.float32), -np.ones(C, np.float32),
                                   np.zeros(C, np.float32), device="cpu")
    return RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
                          calibration=calib, mode="fast", cube_dtype="uint8", device="cpu")


class Payload:
    """Unpickling this writes a marker file: what an attacker's payload
    would do in its place."""

    def __init__(self, marker: str):
        self.marker = marker

    def __reduce__(self):
        return (open, (self.marker, "w"))


def _rewrite(program: bytes, edit) -> bytes:
    """A copy of a torch.export archive with `edit(name, data)` applied to
    each member (returns the new bytes, or None to keep them)."""
    src = zipfile.ZipFile(io.BytesIO(program))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as dst:
        for name in src.namelist():
            data = src.read(name)
            new = edit(name, data)
            dst.writestr(name, data if new is None else new)
    return out.getvalue()


def _duplicate(program: bytes, suffix: str, evil: bytes, evil_first: bool) -> bytes:
    """A copy of a torch.export archive whose member ending in `suffix`
    appears twice: the payload and the harmless original, in this order."""
    src = zipfile.ZipFile(io.BytesIO(program))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as dst, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "Duplicate name"
        for name in src.namelist():
            data = src.read(name)
            pair = (evil, data) if evil_first else (data, evil)
            for d in pair if name.endswith(suffix) else (data,):
                dst.writestr(name, d)
    return out.getvalue()


@pytest.mark.parametrize("where", ["sample_inputs", "constant", "extra_member",
                                   "duplicate_evil_first", "duplicate_evil_last"])
def test_malicious_program_is_refused_and_its_payload_never_runs(tmp_path, predictor, where):
    """A program whose archive carries a pickle with a __reduce__ payload
    (where torch.export.load would run it with the full unpickler: the
    sample inputs' fallback, a constant stored as a pickle, an object
    member, a second sample-inputs entry that torch's reader may pick
    while Python's zipfile picks the other) raises ValueError, and the
    payload never runs."""
    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=4)
    raw = open(path, "rb").read()
    head, _, blob = raw[len(MAGIC):].partition(b"\n")
    meta = json.loads(head)
    marker = tmp_path / "ran"
    evil = io.BytesIO()
    torch.save(Payload(str(marker)), evil)
    evil = evil.getvalue()

    def edit(name, data):
        if where == "sample_inputs" and name.endswith("data/sample_inputs/model.pt"):
            return evil
        if where == "constant" and name.endswith("model_constants_config.json"):
            config = json.loads(data)
            first = next(iter(config["config"].values()))
            first["use_pickle"] = True
            return json.dumps(config).encode()
        if where == "constant" and name.endswith("data/constants/tensor_0"):
            return evil
        return None

    bad = _rewrite(blob, edit)
    if where.startswith("duplicate"):
        bad = _duplicate(blob, _SAMPLE_INPUTS, evil, where == "duplicate_evil_first")
    if where == "extra_member":
        buf = io.BytesIO(bad)
        with zipfile.ZipFile(buf, "a") as z:
            root = z.namelist()[0].split("/", 1)[0]
            z.writestr(f"{root}/data/constants/custom_obj_0", evil)
        bad = buf.getvalue()
    meta["programs"] = {"cpu": len(bad)}
    evil_path = tmp_path / "evil.rmlx"
    evil_path.write_bytes(MAGIC + json.dumps(meta).encode() + b"\n" + bad)
    with pytest.raises(ValueError, match="refused to load"):
        load_serving_artifact(str(evil_path), device="cpu")
    assert not marker.exists()


# -- the kernels as torch ops ------------------------------------------------------


def _op_cases():
    rng = np.random.default_rng(7)
    dims = (5, 7, 9)
    planes = ((5, 9), (7, 9), (5, 7))
    q = [torch.from_numpy(rng.integers(-127, 128, (6,) + s).astype(np.int8)) for s in planes]
    q[1] = None  # a masked plane is a None operand
    cube = torch.from_numpy(rng.integers(-128, 128, (4,) + dims, dtype=np.int8))
    w = i8_score.CombinedWeights(*q, dims=dims + (3,), levels=2)
    kidx = torch.from_numpy(rng.integers(-1, 10, (4, 3)).astype(np.int32))
    ijk = torch.from_numpy(rng.integers(-1, 6, (4, 3, 3)).astype(np.int32))
    valid = torch.from_numpy(rng.random((4, 3)) < 0.7)
    X, S = torch.rand(5, 11), torch.rand(3, 11)
    tm = score.native_templates(*(torch.rand((3,) + s) for s in planes))
    bf = (torch.rand((2,) + dims) * 255).round().to(torch.bfloat16)
    P = (cube, *q, 2)

    def jax_order(t):  # scan-major → the plain versions' axis order
        return (t[0].permute(1, 2, 0), t[1].permute(1, 2, 0), t[2].permute(1, 2, 0))

    return {
        "combo_tables_i8": (P, jax_order,
                            lambda: i8_score.onepass_tables_combined_i8_ref(cube, w)),
        "lookup_tables_i8": (P, jax_order, lambda: i8_tails.onepass_tables_i8_ref(cube, w)),
        "grouped_tables_i8": (P, jax_order,
                              lambda: i8_tails.onepass_tables_grouped_i8_ref(cube, w)),
        "sel_tables_i8": (P + (kidx,),
                          lambda t: (t[0].permute(1, 2, 0), t[1].permute(1, 2, 0),
                                     t[2].permute(2, 1, 0)),
                          lambda: i8_tails.onepass_tables_sel_i8_ref(cube, w, kidx)),
        "sel3_scores_i8": (P + (ijk, valid), lambda t: tuple(x.permute(2, 1, 0) for x in t),
                           lambda: i8_tails.onepass_scores_i8_ref(cube, w, ijk, valid)),
        "rbf_gram": ((X, S, 0.1), lambda t: (t,), lambda: (rbf.rbf_gram_ref(X, S, 0.1),)),
        "native_tables": ((bf, tm.t_xz, tm.t_yz, tm.t_xy), lambda t: t,
                          lambda: score.native_tables_ref(bf, tm)),
    }


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_op_passes_opcheck_and_equals_its_plain_version(name):
    """Each kernel's op: torch.library.opcheck (schema, autograd
    registration, fake shapes and dtypes against the real outputs, AOT
    dispatch) on the CPU, and its CPU output (scan-major) equal, after
    the wrapper's permute, to the kernel's plain version."""
    args, lay_out, plain = _op_cases()[name]
    op = getattr(torch.ops.radarml_torch, name)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    fake_mode = torch._subclasses.fake_tensor.FakeTensorMode()
    with fake_mode:
        fake = op(*(fake_mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    for g, f in zip(got if isinstance(got, tuple) else (got,),
                    fake if isinstance(fake, tuple) else (fake,)):
        assert g.shape == f.shape and g.dtype == f.dtype and g.is_contiguous()
    for g, r in zip(lay_out(got), plain()):
        assert torch.equal(g, r)


def _card_cases():
    """Each kernel's CUDA implementation, called on operands one of which is
    a permuted (non-contiguous) view of the plain case's: (name, call)."""
    args = {name: case[0] for name, case in _op_cases().items()}
    cube, q_xz, q_yz, q_xy, levels = args["combo_tables_i8"]
    w = library._weights(cube, q_xz, q_yz, q_xy, levels)

    def permuted(t):  # the same values, strides of another layout
        return t.transpose(0, 1).contiguous().transpose(0, 1)

    kidx = args["sel_tables_i8"][-1]
    ijk, valid = args["sel3_scores_i8"][-2:]
    X, S, gamma = args["rbf_gram"]
    bf, *tm = args["native_tables"]
    tm = score.NativeTemplates(*tm)
    return {
        "combo_tables_i8": lambda c: i8_score.combo_tables_cuda(c, w),
        "lookup_tables_i8": lambda c: i8_tails.split_tables_cuda("lookup", c, w),
        "grouped_tables_i8": lambda c: i8_tails.split_tables_cuda("grouped", c, w),
        "sel_tables_i8": lambda c: i8_tails.sel_tables_cuda(c, w, kidx),
        "sel_tables_i8/kidx": lambda c: i8_tails.sel_tables_cuda(cube, w, permuted(kidx)),
        "sel3_scores_i8": lambda c: i8_tails.sel3_scores_cuda(c, w, ijk, valid),
        "sel3_scores_i8/ijk": lambda c: i8_tails.sel3_scores_cuda(cube, w, permuted(ijk),
                                                                  valid),
        "rbf_gram": lambda c: rbf.rbf_gram_cuda(permuted(X), S, gamma),
        "native_tables": lambda c: score.native_tables_cuda(permuted(bf), tm),
    }, cube, permuted


@pytest.mark.parametrize("name", sorted(_card_cases()[0]))
def test_cuda_implementation_refuses_what_its_kernel_cannot_read(name):
    """An exported program calls an op's CUDA implementation with no
    wrapper in front, so the implementation itself refuses an operand
    whose layout the kernel would misread by pointer (ValueError, no
    launch), and refuses a tensor that is not on the card."""
    cases, cube, permuted = _card_cases()
    call = cases[name]
    with pytest.raises(ValueError, match="contiguous"):
        call(permuted(cube))
    if "/" not in name and name not in ("rbf_gram", "native_tables"):
        with pytest.raises(ValueError, match="device cpu"):
            call(cube)


def test_full_coupling_loop_gives_the_early_stopped_bits(monkeypatch):
    """An exported SVC program runs all max_iter coupling iterations (no
    host branch can be traced); frozen samples' updates are the identity,
    so its probabilities are the early-stopped loop's, bit for bit."""
    rng = np.random.default_rng(11)
    for k, n in ((2, 5), (3, 300), (5, 64)):
        x = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (n, k, k)).astype(np.float32))
        r = torch.triu(x, 1) + torch.triu(1 - x, 1).transpose(1, 2)
        early = tsvc._couple_probabilities(r)
        never = tsvc._couple_probabilities(r, check_every=10**6)
        with monkeypatch.context() as m:
            m.setattr(torch.compiler, "is_exporting", lambda: True)
            full = tsvc._couple_probabilities(r)
        assert torch.equal(early, full) and torch.equal(early, never)


def test_svc_exact_artifact_equals_live(tmp_path):
    """A small RBF SVC served in exact mode: its artifact (the full
    coupling loop, a traced while_loop) equals the live predictor (early
    stop), bit for bit, on a small scan arena."""
    arena = Arena(r_min=10.0, r_max=60.0, r_res=5.0, theta_min=-12.0, theta_max=12.0,
                  theta_res=6.0, phi_min=-6.0, phi_max=6.0, phi_res=3.0)
    rng = np.random.default_rng(4)
    F, n_sv = arena.feature_length, 12
    m = tsvc.from_numpy(rng.random((n_sv, F)).astype(np.float32),
                        rng.normal(size=(2, n_sv)).astype(np.float32),
                        rng.normal(size=3).astype(np.float32), (4, 4, 4), gamma=0.05,
                        probA=-np.ones(3), probB=np.zeros(3), device="cpu")
    p = RadarPredictor(train_arena=arena, scan_arena=arena, model=m, mode="exact",
                       min_proba=0.0, device="cpu")
    path = str(tmp_path / "svc.rmlx")
    export_predictor(p, path, max_targets=2)
    art = load_serving_artifact(path, device="cpu")
    cubes = np.rint(rng.random((3,) + arena.grid_shape) * 255).astype(np.float32)
    xyz, valid = pad_targets([[(1.0, 0.0, 30.0)], [(-2.0, 1.0, 45.0), (0.0, 0.0, 20.0)], []],
                             max_targets=2)
    _equal(p(cubes, xyz, valid), art(cubes, xyz, valid))

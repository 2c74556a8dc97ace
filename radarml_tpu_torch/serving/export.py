"""AOT serving artifacts: ship the traced predictor, not the code.

Port of radarml_tpu/serving/export.py. The whole predict program of a
RadarPredictor (slicing, zoom or folded tables, the hand-written kernels,
calibrated scoring, thresholding) is traced by `torch.export` into an
`ExportedProgram` and written to one file:

* the batch dimension is symbolic (`torch.export.Dim`), so one artifact
  serves any batch size; mode="fused" keeps the JAX contract of a static
  `batch=` instead, smaller batches padding up inside the artifact;
* reloading needs no model weights, no pipeline construction and no
  model code: the weights are constants of the program, and the kernels
  are the torch ops of ops/library.py, which loading registers first (the
  port's counterpart of "a serving host needs only jax + this loader");
* the artifact holds one program for each device it was exported for
  ("cuda", "cpu"), and loading takes the one of the device asked for.
  A device the artifact lacks raises; nothing falls back.

The container keeps the JAX v2 layout: MAGIC, one JSON metadata line,
then the blob, here the `torch.export.save` archives of the programs
back to back. No unpickler that can run code touches a loaded file:
`torch.export.load` would retry a pickle it failed to load safely with
the full unpickler (and loads some payloads with it directly), so the
loader first refuses any archive that carries such a payload
(`ValueError`), and a ModelReloader watching the path cannot be turned
into code execution by whoever can write it. The port has no legacy
pickle container of its own; a JAX artifact (a StableHLO program) is
refused with a `ValueError` that names its format.

`apps.serve --export_serving/--serving_artifact` wire this into the
streaming service.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import zipfile
from typing import Callable, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "FORMAT",
    "MAGIC",
    "ServingArtifact",
    "export_predictor",
    "load_serving_artifact",
]

FORMAT = "radarml_tpu_torch.serving_export.v2"
# The JAX package's formats: a pickle (v1) or a StableHLO blob (v2).
JAX_FORMATS = ("radarml_tpu.serving_export.v1", "radarml_tpu.serving_export.v2")
MAGIC = b"RMLTPU-SERVING\n"
PLATFORMS = ("cuda", "cpu")

# Members of a torch.export.save archive (under its root folder) that
# hold no pickle: the JSON graph and configs, the raw tensor bytes they
# name, and the format markers. Anything else is refused on load.
_PLAIN_MEMBERS = ("archive_format", "archive_version", "byteorder", ".data/version",
                  ".data/serialization_id", "models/model.json")
_CONFIGS = ("data/weights/model_weights_config.json",
            "data/constants/model_constants_config.json")
_SAMPLE_INPUTS = "data/sample_inputs/model.pt"


class _Program(torch.nn.Module):
    """The predictor's program as the module torch.export traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, cubes, xyz, valid):
        return self.fn(cubes, xyz, valid)


def export_predictor(
    predictor,
    path: str,
    max_targets: int = 4,
    platforms: Optional[Sequence[str]] = None,
    batch: Optional[int] = None,
) -> dict:
    """Export a RadarPredictor's program to `path`.

    Args:
        predictor: a models.pipeline.RadarPredictor (any mode/dtype).
        path: output file.
        max_targets: static target-slot axis baked into the program
            (the batch axis stays symbolic).
        platforms: devices to export for, a subset of ("cuda", "cpu").
            Defaults to the predictor's device only. The program is
            traced on the predictor's device and moved to the others.
        batch: static scan-batch size — REQUIRED for mode="fused", whose
            artifact keeps the JAX contract of a baked batch (smaller
            batches pad up in ServingArtifact.__call__, larger ones
            raise). Other modes keep the symbolic batch axis and ignore
            this.

    Returns the artifact metadata dict.
    """
    from torch.export import Dim
    from torch.export.passes import move_to_device_pass

    from radarml_tpu_torch.models.pipeline import _CUBE_DTYPES

    dev = predictor.device
    platforms = tuple(platforms) if platforms is not None else (dev.type,)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be drawn from {PLATFORMS}, got {platforms}")
    grid = tuple(int(g) for g in predictor.scan_arena.grid_shape)
    if predictor.mode == "fused":
        if batch is None:
            raise ValueError(
                "mode='fused' exports need a static batch= (the artifact "
                "bakes the fused path's scan batch, as the JAX package's does)"
            )
        b, dynamic = int(batch), None
    else:
        # an example batch of 2: torch.export specializes a dimension it
        # sees at 0 or 1
        b = 2
        n = Dim("b", min=1)
        dynamic = ({0: n}, {0: n}, {0: n})
    args = (
        torch.zeros((b,) + grid, dtype=_CUBE_DTYPES[predictor.cube_dtype], device=dev),
        torch.zeros((b, max_targets, 3), dtype=torch.float32, device=dev),
        torch.zeros((b, max_targets), dtype=torch.bool, device=dev),
    )
    with torch.no_grad():
        ep = torch.export.export(_Program(predictor._fn), args, dynamic_shapes=dynamic)
    # Constants that are views of one buffer (the per-plane templates)
    # would be saved as slices of a storage that no constant covers:
    # give each its own.
    for k, v in ep.constants.items():
        if isinstance(v, torch.Tensor):
            ep.constants[k] = v.clone()
    blobs = {}
    # the traced device first: moving a program rewrites it in place
    for p in sorted(platforms, key=lambda p: p != dev.type):
        if p != dev.type:
            ep = move_to_device_pass(ep, p)
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs[p] = buf.getvalue()
    meta = {
        "format": FORMAT,
        "mode": predictor.mode,
        "cube_dtype": str(predictor.cube_dtype),
        "min_proba": float(predictor.min_proba),
        "max_targets": int(max_targets),
        "grid_shape": grid,
        "platforms": list(platforms),
        "programs": {p: len(blobs[p]) for p in platforms},
        **({"batch": int(batch)} if predictor.mode == "fused" else {}),
    }
    # Atomic replace: a ModelReloader watching `path` (train
    # --online_learn or a re-export rewrites it live) must never read
    # a half-written artifact.
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fp:
        fp.write(MAGIC)
        fp.write(json.dumps(meta).encode("utf-8"))
        fp.write(b"\n")
        for p in platforms:
            fp.write(blobs[p])
    os.replace(tmp, path)
    logger.info(
        "exported serving program to %s (%s, batch %s, T=%d)",
        path, meta["platforms"], meta.get("batch", "symbolic"), max_targets,
    )
    return meta


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    """Loaded AOT predictor: call like a RadarPredictor."""

    call: Callable
    mode: str
    cube_dtype: str
    min_proba: float
    max_targets: int
    grid_shape: Tuple[int, ...]
    platforms: Tuple[str, ...]
    # static scan batch for fused-mode artifacts; None = symbolic
    batch: Optional[int] = None
    device: torch.device = torch.device("cpu")  # where the loaded program runs

    def encode_host(self, cubes) -> torch.Tensor:
        """Narrow a canonical 0..255 host cube to the artifact's baked
        stream dtype (see models/pipeline.encode_host_cubes)."""
        from radarml_tpu_torch.models.pipeline import encode_host_cubes

        return encode_host_cubes(cubes, self.cube_dtype)

    def __call__(self, cubes, xyz, valid):
        from radarml_tpu_torch.models.pipeline import _CUBE_DTYPES, encode_int8_cubes

        b = cubes.shape[0]
        if self.batch is not None and b > self.batch:
            raise ValueError(
                f"this fused artifact was exported for a static batch "
                f"of {self.batch} scans, got {b} — score in chunks of "
                f"{self.batch} (the serve CLI's --max_batch does this)"
            )
        dev = self.device
        if self.cube_dtype == "int8":
            # The baked program expects the value-128 wire encoding; a
            # straight cast of canonical 0..255 would overflow int8.
            cubes = encode_int8_cubes(cubes, dev)
        else:
            cubes = torch.as_tensor(cubes).to(dev, dtype=_CUBE_DTYPES[self.cube_dtype])
        # The program was traced on contiguous inputs and holds no
        # .contiguous() of its own (one is a no-op while tracing), so a
        # permuted input is laid out here.
        cubes = cubes.contiguous()
        xyz = torch.as_tensor(xyz, dtype=torch.float32).to(dev).contiguous()
        valid = torch.as_tensor(valid, dtype=torch.bool).to(dev).contiguous()
        if self.batch is not None and b < self.batch:
            # Smaller batches (the unary gRPC path and warm-up run one
            # scan) pad up to the baked shape; pad slots carry
            # valid=False targets and the outputs slice back, so results
            # are unaffected.
            pad = self.batch - b
            cubes = torch.cat([cubes, cubes.new_zeros((pad,) + tuple(cubes.shape[1:]))])
            xyz = torch.cat([xyz, xyz.new_zeros((pad,) + tuple(xyz.shape[1:]))])
            valid = torch.cat([valid, valid.new_zeros((pad,) + tuple(valid.shape[1:]))])
            return tuple(o[:b] for o in self.call(cubes, xyz, valid))
        return self.call(cubes, xyz, valid)


def _refuse_pickles(blob: bytes, path: str) -> None:
    """Raise ValueError unless every member of a torch.export.save archive
    loads without an unpickler that can run code.

    torch.export.load reads pickled weights and constants, custom and
    opaque objects with the full unpickler, and retries sample inputs
    that fail a weights_only load with it; the programs this module
    writes hold none of them (raw tensor bytes, JSON, and sample inputs
    that load weights_only), so an archive that does is refused. The
    members are read through torch's own archive reader, the one that
    torch.export.load reads them with; an archive that names a member
    twice is refused, since two readers may each pick another entry.
    """
    def refuse(why: str):
        raise ValueError(f"{path}: refused to load the serving program: {why}")

    try:
        names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
        reader = torch._C.PyTorchFileReader(io.BytesIO(blob))
        records = reader.get_all_records()
    except (zipfile.BadZipFile, RuntimeError):
        refuse("the program is not a torch.export archive")
    if len(set(names)) != len(names) or len(set(records)) != len(records):
        refuse("the archive names a member twice")
    root = names[0].split("/", 1)[0] + "/" if names else ""
    if not all(n.startswith(root) for n in names):
        refuse("the archive has more than one root folder")
    members = set(records)
    if members != {n[len(root):] for n in names}:
        refuse("the archive's two listings of its members differ")
    tensor_files = set()
    for config in _CONFIGS:
        if config not in members:
            refuse(f"the archive lacks {config}")
        entries = json.loads(reader.get_record(config)).get("config", {})
        folder = config.rsplit("/", 1)[0] + "/"
        for fqn, meta in entries.items():
            name = str(meta.get("path_name", ""))
            if meta.get("use_pickle") or not name.startswith(("tensor_", "weight_")):
                refuse(f"{fqn} is stored as a pickle or object ({name})")
            tensor_files.add(folder + name)
    for member in members:
        if member in _PLAIN_MEMBERS or member in _CONFIGS or member in tensor_files:
            continue
        if member == _SAMPLE_INPUTS:
            try:
                torch.load(io.BytesIO(reader.get_record(member)), weights_only=True)
            except Exception as err:  # any refusal of the safe loader
                refuse(f"its sample inputs need the full unpickler ({type(err).__name__})")
            continue
        refuse(f"unexpected member {member}")


def load_serving_artifact(
    path: str, allow_v1_pickle: bool = False, *, device=None
) -> ServingArtifact:
    """Load an exported predictor; no model code or weights needed.

    Takes the program for `device` (default: the CUDA card, as every
    entry point of the port; pass device="cpu" for the CPU program) and
    raises if the artifact has none. Loading never runs an unpickler
    that can run code (see `_refuse_pickles`), so a `ModelReloader`
    watching the path is safe against artifact-file writers injecting
    code. The port has no legacy pickle artifacts: `allow_v1_pickle` is
    kept for the JAX package's signature, and True raises ValueError at
    once. A file without the header, and a JAX artifact, raise
    ValueError too.
    """
    from radarml_tpu_torch.core.device import resolve_device
    from radarml_tpu_torch.ops import library  # noqa: F401  (the graph's ops)

    if allow_v1_pickle:
        raise ValueError(
            "allow_v1_pickle=True: this port has no legacy v1 pickle "
            "artifacts and never unpickles one"
        )
    with open(path, "rb") as fp:
        raw = fp.read()
    if not raw.startswith(MAGIC):
        raise ValueError(
            f"{path} is not a serving artifact (no {MAGIC!r} header); this "
            "port never unpickles one — export one with export_predictor"
        )
    head, _, blob = raw[len(MAGIC):].partition(b"\n")
    payload = json.loads(head.decode("utf-8"))
    fmt = payload.get("format")
    if fmt in JAX_FORMATS:
        raise ValueError(
            f"{path} is a {fmt} artifact, the JAX package's StableHLO "
            f"program; this port loads {FORMAT} artifacts only — re-export "
            "the model with radarml_tpu_torch.serving.export_predictor"
        )
    if fmt != FORMAT:
        raise ValueError(f"not a serving export artifact: {path}")
    dev = resolve_device(device)
    programs = payload["programs"]
    if sum(programs.values()) != len(blob):
        raise ValueError(f"{path}: the programs' sizes do not add up to the blob's")
    if dev.type not in programs:
        raise ValueError(
            f"{path} holds programs for {list(programs)}, none for {dev.type}; "
            "export it with that platform"
        )
    off = 0
    for p, n in programs.items():
        if p == dev.type:
            program = blob[off:off + n]
            break
        off += n
    _refuse_pickles(program, path)
    ep = torch.export.load(io.BytesIO(program))
    return ServingArtifact(
        call=ep.module(),
        mode=payload["mode"],
        cube_dtype=payload["cube_dtype"],
        min_proba=payload["min_proba"],
        max_targets=payload["max_targets"],
        grid_shape=tuple(payload["grid_shape"]),
        platforms=tuple(payload["platforms"]),
        batch=payload.get("batch"),
        device=dev,
    )

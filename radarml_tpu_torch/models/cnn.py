"""Multi-view CNN classifier ("DNN" family).

Port of radarml_tpu/models/cnn.py, the reference's Keras classifier
(dnn.py:45-91): three convolutional branches, one per radar projection
(xz, yz, xy), each Conv 64→32, 3×3, stride 2, SAME, ReLU; concatenated,
flattened, then Dense(64)+Dropout(0.5) twice and a logits head.

The layers keep flax's conventions so that a model trained by either
package computes the same function in the other:

* SAME padding follows lax's rule, total = max((out−1)·s + k − in, 0)
  with the smaller half before: stride 2 on an even side pads (0, 1),
  which `nn.Conv2d(padding=1)` would not.
* The flatten after the channel concat runs over (H, W, C), as an NHWC
  flatten does, so the first Dense's rows need no permutation.
* Parameters are named as in the flax tree (`branch_xz.Conv_0`,
  `Dense_0`, …). `flax_to_state_dict` / `state_dict_to_flax` carry a
  tree between the flax layout (HWIO conv kernels, (in, out) dense
  kernels, unflipped ConvTranspose kernels, BatchNorm scale/mean/var)
  and torch state dicts; the SGAN (models/sgan.py) shares them.

Dropout takes its keep masks as tensors (`dropout_masks`), so the caller
owns the random stream. Building a network turns TF32 off
(models/linear.full_f32): cuDNN's default would cost the convolutions
about three decimal digits against the JAX package's float32. Inputs
are (B, H, W, 3) in [-1, 1] at RESCALE (80×80) — see
data/preprocess.py.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.models.linear import full_f32

__all__ = [
    "RESCALE",
    "SameConv2d",
    "ViewBranch",
    "MultiViewCNN",
    "dropout_masks",
    "flax_to_state_dict",
    "state_dict_to_flax",
    "init_tree",
    "cnn_init_tree",
    "init_cnn",
    "cnn_params_from_numpy",
    "cnn_params_to_numpy",
    "cnn_predict_proba",
]

RESCALE: Tuple[int, int] = (80, 80)  # reference dnn.py:33


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax's SAME padding of one axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _tap_view(z: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, kh, kw, h, w) view of contiguous padded tap planes z (B, kh·kw,
    h + kh − 1, w + kw − 1): element (b, dy, dx, i, j) is z[b, dy·kw + dx,
    i + dy, j + dx]. The taps are a strided lattice of z's storage, and no
    two elements share an address."""
    B, T, hp, wp = z.shape
    sb, st = z.stride(0), z.stride(1)
    return z.as_strided((B, kh, kw, hp - kh + 1, wp - kw + 1),
                        (sb, kw * st + wp, st + 1, wp, 1))


class _ShiftSum(torch.autograd.Function):
    """y[b, i, j] = Σ_t z[b, t, i + dy_t, j + dx_t] over the kh·kw taps
    t = dy·kw + dx of contiguous padded planes z: one reduction forward,
    one fill and one copy backward."""

    @staticmethod
    def forward(ctx, z, kh: int, kw: int):
        ctx.taps = (kh, kw, z.shape)
        # a channels-last input to the 1×1 convolution gives a channels-last z
        return _tap_view(z.contiguous(), kh, kw).sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        kh, kw, shape = ctx.taps
        dz = g.new_zeros(shape)
        _tap_view(dz, kh, kw).copy_(g[:, None, None].expand(-1, kh, kw, -1, -1))
        return dz, None, None


class SameConv2d(nn.Conv2d):
    """Conv2d with flax/TF SAME padding, computed from the input size.

    A stride-1 convolution to one output channel (the generator's last
    7×7 layer) runs as a 1×1 convolution to one plane per tap, then a
    shifted sum of the planes: cuDNN's float32 algorithms for a single
    output channel took ~150 of a 281 ms SGAN step on an NVIDIA H100
    80GB HBM3 at 700 W (PERF.md §6).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(n, k, s)
            for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride)
        )
        if self.out_channels == 1 and self.stride == (1, 1):
            kh, kw = self.kernel_size
            taps = self.weight[0].permute(1, 2, 0).reshape(kh * kw, -1, 1, 1)
            z = F.pad(F.conv2d(x, taps), (left, right, top, bottom))
            return (_ShiftSum.apply(z, kh, kw) + self.bias)[:, None]
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride)


def dropout_masks(
    n: int, shape: Sequence[int], rate: float, generator: torch.Generator
) -> Optional[list]:
    """`n` float32 multipliers keep/(1−rate) of `shape`, keep drawn as
    uniform < 1−rate (flax's Bernoulli), on the generator's device; None
    when rate is 0 (dropout off)."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    return [
        (torch.rand(tuple(shape), generator=generator, device=generator.device) < keep)
        .to(torch.float32) / keep
        for _ in range(n)
    ]


# --------------------------------------------------------------------------
# flax tree <-> torch state dict
# --------------------------------------------------------------------------

_LEAF_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}
_LEAF_TO_FLAX = {"running_mean": "mean", "running_var": "var"}


def _kernel_to_torch(layer: str, k: np.ndarray) -> np.ndarray:
    if layer.startswith("ConvTranspose"):
        # flax's ConvTranspose does not flip its kernel; torch's
        # ConvTranspose2d (in, out, kh, kw) is the flipped correlation.
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


def _weight_to_flax(layer: str, w: np.ndarray) -> np.ndarray:
    if layer.startswith("ConvTranspose"):
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def flax_to_state_dict(*trees) -> "OrderedDict[str, torch.Tensor]":
    """Flax-layout trees (params, and batch_stats where there are any) as
    one torch state dict of float32 CPU tensors."""
    out = OrderedDict()

    def walk(node, path):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            a = np.asarray(val, np.float32)
            if key == "kernel":
                name, a = "weight", _kernel_to_torch(path[-1], a)
            else:
                name = _LEAF_TO_TORCH[key]
            out[".".join(path + (name,))] = torch.from_numpy(np.array(a))  # a writable copy

    for tree in trees:
        walk(tree, ())
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """A state dict (or any dict of tensors under its keys, e.g. Adam
    moments) as flax-layout numpy trees: (params, batch_stats)."""
    params: dict = {}
    stats: dict = {}
    for key, t in state.items():
        *path, name = key.split(".")
        a = t.detach().cpu().numpy()
        if name in _LEAF_TO_FLAX:
            tree, leaf = stats, _LEAF_TO_FLAX[name]
        elif name == "weight" and a.ndim >= 2:
            tree, leaf, a = params, "kernel", _weight_to_flax(path[-1], a)
        elif name == "weight":
            tree, leaf = params, "scale"
        else:
            tree, leaf = params, name
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return params, stats


def init_tree(template: dict, seed: int, kernel_init) -> dict:
    """A flax-layout numpy tree shaped like `template`: kernels from
    `kernel_init(shape, rng)`, biases and means 0, scales and variances 1,
    drawn in sorted path order from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key == "kernel":
                out[key] = kernel_init(val.shape, rng).astype(np.float32)
            else:
                fill = 1.0 if key in ("scale", "var") else 0.0
                out[key] = np.full(val.shape, fill, np.float32)
        return out

    return walk(template)


def lecun_normal(shape, rng: np.random.Generator) -> np.ndarray:
    """flax's default kernel init: truncated (±2σ) normal, variance
    1/fan_in, fan_in the product of all but the last axis."""
    std = np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return out * std


# --------------------------------------------------------------------------
# The network
# --------------------------------------------------------------------------

class ViewBranch(nn.Module):
    """Conv trunk for one projection (dnn.py:45-52)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = SameConv2d(1, 64, 3, 2)
        self.Conv_1 = SameConv2d(64, 32, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


class MultiViewCNN(nn.Module):
    """Three-branch projection classifier (dnn.py:55-91).

    `rescale` fixes the first Dense's width (flax infers it at init).
    """

    def __init__(self, n_classes: int = 3, rescale: Tuple[int, int] = RESCALE,
                 dense_width: int = 64, dropout_rate: float = 0.5):
        super().__init__()
        full_f32()  # cuDNN would run its convolutions in TF32 otherwise
        self.n_classes = n_classes
        self.rescale = tuple(rescale)
        self.dense_width = dense_width
        self.dropout_rate = dropout_rate
        self.branch_xz = ViewBranch()
        self.branch_yz = ViewBranch()
        self.branch_xy = ViewBranch()
        h, w = (math.ceil(n / 4) for n in rescale)  # two stride-2 convs
        flat = h * w * 96
        self.Dense_0 = nn.Linear(flat, dense_width)
        self.Dense_1 = nn.Linear(dense_width, dense_width)
        self.Dense_2 = nn.Linear(dense_width, n_classes)

    def forward(self, views: torch.Tensor, masks: Optional[Sequence] = None) -> torch.Tensor:
        """views: (B, H, W, 3) with channels (xz, yz, xy); `masks`: the two
        dropout multipliers of `dropout_masks` ((B, dense_width) each), or
        None for inference. Returns (B, n_classes) logits."""
        x = views.permute(0, 3, 1, 2)
        x = torch.cat([self.branch_xz(x[:, 0:1]), self.branch_yz(x[:, 1:2]),
                       self.branch_xy(x[:, 2:3])], dim=1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i, dense in enumerate((self.Dense_0, self.Dense_1)):
            x = F.relu(dense(x))
            if masks is not None:
                x = x * masks[i]
        return self.Dense_2(x)


def cnn_init_tree(n_classes: int, rescale: Tuple[int, int] = RESCALE,
                  seed: int = 1234) -> dict:
    """A MultiViewCNN's flax `params` tree as numpy, made from `seed` with
    flax's default initializers (lecun-normal kernels, zero biases)."""
    template, _ = state_dict_to_flax(MultiViewCNN(n_classes, rescale).state_dict())
    return init_tree(template, seed, lecun_normal)


def cnn_params_from_numpy(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """The flax `params` tree of a `cnn` artifact as a MultiViewCNN state
    dict (load it with `model.load_state_dict`)."""
    return flax_to_state_dict(tree)


def cnn_params_to_numpy(model_or_state) -> dict:
    """Inverse of cnn_params_from_numpy: the flax `params` tree (numpy)."""
    state = (model_or_state.state_dict() if isinstance(model_or_state, nn.Module)
             else model_or_state)
    return state_dict_to_flax(state)[0]


def init_cnn(n_classes: int, rescale: Tuple[int, int] = RESCALE, seed: int = 1234,
             device: torch.device | str | None = None,
             dropout_rate: float = 0.5) -> MultiViewCNN:
    """A MultiViewCNN on `device` (default: the card) with the weights of
    cnn_init_tree(n_classes, rescale, seed)."""
    model = MultiViewCNN(n_classes, rescale, dropout_rate=dropout_rate)
    model.load_state_dict(cnn_params_from_numpy(cnn_init_tree(n_classes, rescale, seed)))
    return model.to(resolve_device(device))


@torch.no_grad()
def cnn_predict_proba(model: MultiViewCNN, views: torch.Tensor) -> torch.Tensor:
    """Inference-mode class probabilities of (B, H, W, 3) views."""
    return torch.softmax(model(views), dim=-1)

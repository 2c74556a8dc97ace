"""Semi-supervised GAN family: generator, two-headed discriminator.

Port of radarml_tpu/models/sgan.py (the reference's SGAN graphs,
sgan.py:57-235):

* Generator: a 100-d latent feeds three independent per-projection
  branches — Dense(8·8·128)+ReLU → reshape (8, 8, 128) →
  n × [ConvTranspose(128, 4×4, s2, SAME) + BN + ReLU] → Conv(1, 7×7,
  SAME, tanh). Outputs (xz, yz, xy), each (B, S, S, 1) in [-1, 1],
  S = 8·2^n (128 in the reference).
* Discriminator: per-projection trunk of Conv(128→64→32, 3×3, s2,
  SAME)+BN+LeakyReLU(0.2); channel concat; flatten over (H, W, C);
  2 × [Dense(64)+BN+LeakyReLU+Dropout(0.5)]; Dense(k) logits. The
  supervised head is the softmax of the logits (`c_head`), the
  unsupervised real/fake head Z/(Z+1), Z = Σ exp(logits) (`d_head`).

RandomNormal(0, 0.02) kernels and Keras/flax BatchNorm (momentum 0.99,
ε 1e-3). `FlaxBatchNorm` keeps flax's arithmetic: the batch variance is
E[x²] − E[x]² (clipped at 0), the running variance is updated with that
biased variance (torch's BatchNorm uses the unbiased one), and the
output is (x − mean)·(scale·rsqrt(var + ε)) + bias. (PyTorch's fused
batch norm, which centres its sums, parted the fused SGAN step from the
JAX one beyond the bars of tests/test_torch_sgan.py.) flax's
ConvTranspose(…, SAME) correlates the input dilated by 2 with its kernel
unflipped; `nn.ConvTranspose2d(k=4, s=2, padding=1)` computes it with
the kernel flipped and its channels swapped (models/cnn.py carries the
weights). The GAN composite's freeze rule (everything in the
discriminator frozen except BatchNorm) lives in the trainer.

The discriminator takes the (B, H, W, 3) view stack (the JAX module
takes its three (B, H, W, 1) slices); dropout takes its masks as tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radarml_tpu_torch.models.cnn import SameConv2d, flax_to_state_dict, init_tree, \
    state_dict_to_flax
from radarml_tpu_torch.models.linear import full_f32

__all__ = [
    "LATENT_DIM",
    "SGAN_RESCALE",
    "FlaxBatchNorm",
    "Generator",
    "Discriminator",
    "custom_activation",
    "d_head",
    "c_head",
    "sgan_init_trees",
    "sgan_params_from_numpy",
    "sgan_params_to_numpy",
]

LATENT_DIM = 100  # sgan.py:800-810 default
SGAN_RESCALE: Tuple[int, int] = (128, 128)  # sgan.py:39


def custom_activation(logits: torch.Tensor) -> torch.Tensor:
    """Z/(Z+1), Z = Σ exp(logits): P(real) from class logits, as the
    sigmoid of the log-sum-exp."""
    return torch.sigmoid(torch.logsumexp(logits, dim=-1, keepdim=True))


class FlaxBatchNorm(nn.Module):
    """BatchNorm over every axis but 1, with flax's statistics."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            axes = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class _GenBranch(nn.Module):
    """One per-projection upsampling branch (sgan.py:57-92)."""

    def __init__(self, n_upsamples: int, latent_dim: int, bn_momentum: float):
        super().__init__()
        self.n_upsamples = n_upsamples
        self.Dense_0 = nn.Linear(latent_dim, 8 * 8 * 128)
        for i in range(n_upsamples):
            setattr(self, f"ConvTranspose_{i}", nn.ConvTranspose2d(128, 128, 4, 2, padding=1))
            setattr(self, f"BatchNorm_{i}", FlaxBatchNorm(128, bn_momentum))
        self.Conv_0 = SameConv2d(128, 1, 7)

    def forward(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.Dense_0(z)).view(-1, 8, 8, 128).permute(0, 3, 1, 2)
        for i in range(self.n_upsamples):
            up = getattr(self, f"ConvTranspose_{i}")
            x = F.relu(getattr(self, f"BatchNorm_{i}")(up(x), train))
        return torch.tanh(self.Conv_0(x))  # (B, 1, S, S)


class Generator(nn.Module):
    """Latent → (xz, yz, xy) projections, each (B, S, S, 1) with
    S = 8·2^n_upsamples (128 in the reference)."""

    def __init__(self, n_upsamples: int = 4, latent_dim: int = LATENT_DIM,
                 bn_momentum: float = 0.99):
        super().__init__()
        full_f32()  # no TF32 in cuDNN's convolutions (models/cnn.py)
        self.n_upsamples = n_upsamples
        self.latent_dim = latent_dim
        for name in ("xz", "yz", "xy"):
            setattr(self, name, _GenBranch(n_upsamples, latent_dim, bn_momentum))

    @property
    def out_size(self) -> int:
        return 8 * (2 ** self.n_upsamples)

    def forward(self, z: torch.Tensor, train: bool = True):
        return tuple(b(z, train).permute(0, 2, 3, 1) for b in (self.xz, self.yz, self.xy))


class _DiscBranch(nn.Module):
    """One per-projection downsampling trunk (sgan.py:136-157)."""

    def __init__(self, bn_momentum: float):
        super().__init__()
        chans = (1, 128, 64, 32)
        for i in range(3):
            setattr(self, f"Conv_{i}", SameConv2d(chans[i], chans[i + 1], 3, 2))
            setattr(self, f"BatchNorm_{i}", FlaxBatchNorm(chans[i + 1], bn_momentum))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train)
            x = F.leaky_relu(x, 0.2)
        return x


class Discriminator(nn.Module):
    """Shared trunk producing the k class logits both heads consume.
    `rescale` fixes the first Dense's width (flax infers it at init)."""

    def __init__(self, n_classes: int = 3, rescale: Tuple[int, int] = SGAN_RESCALE,
                 dense_width: int = 64, dropout_rate: float = 0.5,
                 bn_momentum: float = 0.99):
        super().__init__()
        full_f32()  # no TF32 in cuDNN's convolutions (models/cnn.py)
        self.n_classes = n_classes
        self.rescale = tuple(rescale)
        self.dense_width = dense_width
        self.dropout_rate = dropout_rate
        for name in ("xz", "yz", "xy"):
            setattr(self, name, _DiscBranch(bn_momentum))
        h, w = (math.ceil(n / 8) for n in rescale)  # three stride-2 convs
        self.Dense_0 = nn.Linear(h * w * 96, dense_width)
        self.BatchNorm_0 = FlaxBatchNorm(dense_width, bn_momentum)
        self.Dense_1 = nn.Linear(dense_width, dense_width)
        self.BatchNorm_1 = FlaxBatchNorm(dense_width, bn_momentum)
        self.Dense_2 = nn.Linear(dense_width, n_classes)

    def forward(self, views: torch.Tensor, train: bool = True,
                masks: Optional[Sequence] = None) -> torch.Tensor:
        """views: (B, H, W, 3) stack (xz, yz, xy); `masks`: the two dropout
        multipliers ((B, dense_width) each) or None (no dropout). In train
        mode the BatchNorms normalise by, and update from, the batch."""
        x = views.permute(0, 3, 1, 2)
        x = torch.cat([self.xz(x[:, 0:1], train), self.yz(x[:, 1:2], train),
                       self.xy(x[:, 2:3], train)], dim=1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i, (dense, bn) in enumerate(((self.Dense_0, self.BatchNorm_0),
                                         (self.Dense_1, self.BatchNorm_1))):
            x = F.leaky_relu(bn(dense(x), train), 0.2)
            if masks is not None:
                x = x * masks[i]
        return self.Dense_2(x)


def c_head(logits: torch.Tensor) -> torch.Tensor:
    """Supervised head: class probabilities (sgan.py:203-209)."""
    return torch.softmax(logits, dim=-1)


def d_head(logits: torch.Tensor) -> torch.Tensor:
    """Unsupervised head: P(real) (sgan.py:211-217)."""
    return custom_activation(logits)


def _normal_002(shape, rng: np.random.Generator) -> np.ndarray:
    return rng.normal(0.0, 0.02, shape)


def sgan_init_trees(n_classes: int, rescale: Tuple[int, int] = SGAN_RESCALE,
                    seed: int = 1234, latent_dim: int = LATENT_DIM):
    """flax-layout numpy trees of a fresh SGAN, made from `seed`:
    ((g_params, g_stats), (d_params, d_stats)), RandomNormal(0, 0.02)
    kernels, zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1."""
    n_up = n_upsamples_for(rescale)
    out = []
    for i, module in enumerate((Generator(n_up, latent_dim),
                                Discriminator(n_classes, rescale))):
        params, stats = state_dict_to_flax(module.state_dict())
        out.append((init_tree(params, seed + i, _normal_002),
                    init_tree(stats, seed + i, _normal_002)))
    return tuple(out)


def n_upsamples_for(rescale: Tuple[int, int]) -> int:
    """The generator depth for a square 8·2^n side."""
    if rescale[0] != rescale[1] or rescale[0] % 8:
        raise ValueError("rescale must be square and 8·2^n")
    n_up = int(np.log2(rescale[0] // 8))
    if 8 * 2**n_up != rescale[0]:
        raise ValueError("rescale side must be 8·2^n")
    return n_up


def sgan_params_from_numpy(params: dict, stats: Optional[dict] = None):
    """A generator's or discriminator's flax `params` and `batch_stats`
    trees (numpy, e.g. an `sgan_classifier` artifact's d_params and
    d_stats) as the module's state dict."""
    return flax_to_state_dict(params, stats or {})


def sgan_params_to_numpy(module_or_state) -> Tuple[dict, dict]:
    """Inverse of sgan_params_from_numpy: (params, batch_stats) numpy trees."""
    state = (module_or_state.state_dict() if isinstance(module_or_state, nn.Module)
             else module_or_state)
    return state_dict_to_flax(state)

"""Fused RBF Gram matrix for the kernel-SVM family.

Port of radarml_tpu/ops/pallas_rbf.py :: rbf_gram. For float32 rows X
(n, F) and S (m, F),

    K[r, c] = exp(-gamma * max(|x_r|^2 + |s_c|^2 - 2 <x_r, s_c>, 0))

The SVC fit takes it over its training set and serving over the query
features against the support vectors.

On a CUDA tensor `rbf_gram` launches the hand-written Hopper kernel
`csrc/rbf_gram.cu` (its header says what bounds it and how it is laid
out) or raises; on a CPU tensor it runs the plain version
`rbf_gram_ref`. Nothing falls back from one to the other. The caller
pads and slices nothing (the TPU kernel's wrapper padded to 128-row
tiles and sliced afterwards): the kernel's pack passes pad the operands
into scratch and its main pass stores exactly (n, m).
"""

from __future__ import annotations

import ctypes

import torch

from radarml_tpu_torch.ops._cuda_build import count_launch

__all__ = ["KERNEL_LAUNCHES", "rbf_gram", "rbf_gram_ref"]

#: Launches of the CUDA kernel in this process. Only the wrapper adds to
#: it, once per launch; callers reset it to 0 to count a run.
KERNEL_LAUNCHES = 0


def rbf_gram_ref(X: torch.Tensor, S: torch.Tensor, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's XLA formulation
    (models/svc.py:70-78) — one full-float32 product (no TF32), row
    norms, the distance expansion, clamp, exp."""
    # models.linear.full_f32, inlined: ops/ must not import models/
    torch.backends.cuda.matmul.allow_tf32 = False
    X = X.to(torch.float32)
    S = S.to(torch.float32)
    G = X @ S.T
    xx = (X * X).sum(dim=1)
    ss = (S * S).sum(dim=1)
    d2 = xx[:, None] + ss[None, :] - 2.0 * G
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def _check(X: torch.Tensor, S: torch.Tensor) -> None:
    for name, t in (("X", X), ("S", S)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(
                f"{name} must be a 2-D float32 tensor, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if X.shape[1] != S.shape[1]:
        raise ValueError(
            f"X has {X.shape[1]} features, S has {S.shape[1]}"
        )
    if X.device != S.device:
        raise ValueError(f"X on {X.device}, S on {S.device}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.rbf_gram_f32.argtypes = [p, p, p, p, ctypes.c_size_t, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
    lib.rbf_gram_f32.restype = ctypes.c_int
    lib.rbf_gram_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.rbf_gram_workspace_bytes.restype = ctypes.c_size_t
    return lib


def _library() -> ctypes.CDLL:
    from radarml_tpu_torch.ops._cuda_build import load_library

    return _bind(load_library("rbf_gram"))


def rbf_gram(X: torch.Tensor, S: torch.Tensor, gamma: float) -> torch.Tensor:
    """(n, F) x (m, F) float32 → (n, m) float32 fused RBF Gram matrix.

    On a CUDA tensor the kernel writes exactly (n, m) on the current
    stream; it takes contiguous row-major inputs of any alignment (an odd
    F, a view that starts mid-buffer) and raises on any other. Its pack
    passes write the operands as tiles into scratch allocated here (about
    n F + 2 m F floats). On a CPU tensor this is `rbf_gram_ref`. Both go
    through the torch op `radarml_torch::rbf_gram` (ops/library.py).
    """
    _check(X, S)
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rbf_gram kernel for device {X.device}")
    return torch.ops.radarml_torch.rbf_gram(X, S, float(gamma))


def rbf_gram_cuda(X: torch.Tensor, S: torch.Tensor, gamma: float) -> torch.Tensor:
    """Launch the kernel on CUDA operands, checked here: an exported
    program calls the op directly, so these checks run on every call. The
    CUDA implementation of `radarml_torch::rbf_gram`; counts the launch."""
    _check(X, S)
    if not (X.is_contiguous() and S.is_contiguous()):
        raise ValueError("the kernel takes contiguous row-major X and S")
    if X.shape[0] == 0 or S.shape[0] == 0 or X.shape[1] == 0:
        raise ValueError(f"empty Gram matrix: n={X.shape[0]}, m={S.shape[0]}, "
                         f"F={X.shape[1]}")
    if X.device.type != "cuda":
        raise ValueError(f"no rbf_gram kernel for device {X.device}")
    n, F = X.shape
    m = S.shape[0]
    lib = _library()
    dev = X.device
    nbytes = lib.rbf_gram_workspace_bytes(n, m, F)
    if nbytes == 0:
        raise ValueError(f"the kernel does not take n={n}, m={m}, F={F}")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    work = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rbf_gram_f32(X.data_ptr(), S.data_ptr(), out.data_ptr(),
                               work.data_ptr(), nbytes, n, m, F, float(gamma),
                               stream)
    if err != 0:
        raise RuntimeError(
            f"rbf_gram_f32 launch failed: CUDA error {err} (n={n}, m={m}, F={F})"
        )
    count_launch(globals(), "KERNEL_LAUNCHES")
    return out

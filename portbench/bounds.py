"""Peaks of the card and the least work of each measured thing.

A share of a roofline is the least time the card could take for the work
over the time it took: the larger of the bytes that must move over the
memory's rate and the operations over the compute rate. Bytes count
each input read once and each output written once; operations count
what the inputs need. So no implementation, however it computes the
work, reads more than 100%.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
BF16_FLOPS_S = 989e12


def least_s(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_tables(B: int, dims: Sequence[int], C2: int) -> Tuple[float, str]:
    """Kernel B1 over B int8 cubes (X, Y, Z) against C2 template rows:
    cubes and templates read once, the three int32 tables (C2 rows of Y,
    X and Z entries a scan) written once; 2 int8 operations a
    multiply-add, 3 C2 multiply-adds a voxel."""
    X, Y, Z = dims
    vox = X * Y * Z
    nbytes = B * vox + C2 * (X * Z + Y * Z + X * Y) + 4 * B * C2 * (X + Y + Z)
    return least_s(nbytes, 2 * 3 * B * C2 * vox, INT8_OPS_S)


def rbf_gram(n: int, m: int, F: int) -> Tuple[float, str]:
    """Kernel B6's (n, m) float32 Gram of n query rows against m support
    vectors of F features: both read once and the Gram written once, in
    float32; 2 n m F operations at the bf16 tensor-core rate, one bf16
    product a product, which no float32-accurate route undercuts."""
    return least_s(4 * (n * F + m * F + n * m), 2 * n * m * F, BF16_FLOPS_S)


def zoom_ops(planes_in: Sequence[Tuple[int, int]],
             planes_out: Sequence[Tuple[int, int]]) -> int:
    """Operations to zoom one target's planes by separable products, in
    the cheaper order of the two passes; an axis that keeps its length
    needs none."""
    total = 0
    for (h, w), (oh, ow) in zip(planes_in, planes_out):
        rows_first = (2 * oh * h * w if oh != h else 0) + (2 * ow * w * oh if ow != w else 0)
        cols_first = (2 * ow * w * h if ow != w else 0) + (2 * oh * h * ow if oh != h else 0)
        total += min(rows_first, cols_first)
    return total


def io_bytes(n_slots: int, n_classes: int) -> int:
    """A step's target positions (float32 x, y, z) and validity flags
    read, and its answers (an int32 class and float32 probabilities a
    slot) written."""
    return n_slots * (3 * 4 + 1) + n_slots * 4 * (1 + n_classes)


def linear_step(n_valid: int, n_slots: int, voxels: int, planes_in, planes_out,
                n_classes: int, n_features: int) -> Tuple[float, str]:
    """A step of the linear configuration: the `voxels` that the valid
    targets' planes cover (each read once, at one byte), the model (float32 weights,
    intercepts and calibration) read once, the step's targets and
    answers; the operations of the cheaper of two routes, the class
    dot products at the planes' own size (the zoom folded into the
    weights) or the zoom then the dot products at the training size, at
    the int8 rate (8-bit scans, the weights as int8 splits)."""
    native = sum(h * w for h, w in planes_in)
    nbytes = (voxels + 4 * n_classes * (n_features + 3)
              + io_bytes(n_slots, n_classes))
    per_target = min(2 * n_classes * native,
                     zoom_ops(planes_in, planes_out) + 2 * n_classes * n_features)
    return least_s(nbytes, n_valid * per_target, INT8_OPS_S)


def svc_step(n_valid: int, n_slots: int, voxels: int, planes_in, planes_out,
             n_classes: int, n_features: int, n_sv: int) -> Tuple[float, str]:
    """A step of the kernel-SVM configuration: the `voxels` that the
    valid targets' planes cover (each read once, at one byte), the float32 support vectors
    and coefficients read once, the step's targets and answers; the
    zoom of each valid target's planes, its 2 n_sv F Gram operations and
    its one-vs-one decisions, at the bf16 tensor-core rate."""
    n_pairs = n_classes * (n_classes - 1) // 2
    nbytes = (voxels + 4 * (n_sv * n_features + (n_classes - 1) * n_sv
                                       + 3 * n_pairs)
              + io_bytes(n_slots, n_classes))
    per_target = (zoom_ops(planes_in, planes_out) + 2 * n_sv * n_features
                  + 2 * n_sv * n_pairs)
    return least_s(nbytes, n_valid * per_target, BF16_FLOPS_S)

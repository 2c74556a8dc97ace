"""Data-parallel softmax-regression step over a mesh.

Port of radarml_tpu/parallel/train_step.py. Parameters are replicated,
the batch is sharded over "data" (each rank passes its own slice), and
each rank's loss is its rows' share of the global mean, so the
gradients summed over the data ranks are the global batch's: the
standard data-parallel recipe, written out where XLA inserts it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from radarml_tpu_torch.parallel.mesh import Mesh

__all__ = ["make_dp_sgd_train_step"]


def make_dp_sgd_train_step(
    mesh: Optional[Mesh], n_classes: int, lr: float = 0.01, weight_decay: float = 0.0
) -> Callable:
    """One softmax-regression minibatch step, batch sharded over "data".

    Signature: step(params, X, y) → (params, loss), with params
    {"coef": (C, F), "intercept": (C,)} and X, y this rank's rows (all of
    them without a mesh). The loss is the global batch's mean negative
    log-likelihood plus weight_decay·Σcoef², on every rank.
    """
    del n_classes  # the shapes carry it; kept for the JAX signature

    def step(params: Dict[str, torch.Tensor], X, y) -> Tuple[Dict[str, torch.Tensor],
                                                              torch.Tensor]:
        coef = params["coef"].detach().requires_grad_(True)
        intercept = params["intercept"].detach().requires_grad_(True)
        X = torch.as_tensor(X, dtype=torch.float32, device=coef.device)
        y = torch.as_tensor(y, dtype=torch.int64, device=coef.device)
        n = X.shape[0] * (1 if mesh is None else mesh.data_size)
        logp = torch.log_softmax(X @ coef.T + intercept, dim=-1)
        loss = -logp.gather(1, y[:, None]).sum() / n
        if weight_decay and (mesh is None or mesh.data_rank == 0):
            loss = loss + weight_decay * torch.sum(coef * coef)  # counted once
        g_coef, g_int = torch.autograd.grad(loss, (coef, intercept))
        loss = loss.detach()
        if mesh is not None:
            flat = torch.cat([g_coef.reshape(-1), g_int, loss[None]])
            mesh.all_reduce_(flat)
            g_coef = flat[:g_coef.numel()].view_as(g_coef)
            g_int = flat[g_coef.numel():-1]
            loss = flat[-1]
        with torch.no_grad():
            new = {"coef": coef - lr * g_coef, "intercept": intercept - lr * g_int}
        return new, loss

    return step

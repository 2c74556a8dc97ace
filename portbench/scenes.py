"""Synthetic radar scenes, drawn in batches on the device from a seed.

The scene draw of the program's synthetic source (a noise floor and
class-dependent Gaussian target blobs, `data/synthetic.py`), rewritten
in batched torch so that thousands of scans take milliseconds: a scan is
exponential speckle plus a range-decaying floor, with up to `slots`
targets, each a sum of `n_lobes` separable Gaussian lobes of its class's
signature, clipped to 0..255 and rounded to uint8. Every number comes
from one torch.Generator on the device, so a seed gives the same scans.

Sizes are physical (degrees and cm): the source's sizes in cells of the
default arena (4 degrees of theta, 2 of phi, 2 cm of r) times those
cells, so a finer arena scans the same scene in more cells and its zoom
into the training arena gives features like the training arena's. At
the default arena the scenes are the source's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from portbench.reference.arena import Arena

#: Class signatures: (theta sd in degrees, phi sd in degrees, r sd in cm,
#: amplitude, lobes, gap between lobes in cm): the program's synthetic
#: source's (2.5, 3.5, 6.0 cells; a 14-cell gap) at the default arena.
SIGNATURES = {
    "person": (10.0, 7.0, 12.0, 230.0, 3, 28.0),
    "dog": (6.4, 4.4, 8.0, 190.0, 2, 18.0),
    "cat": (4.0, 2.8, 5.0, 150.0, 1, 0.0),
}
MAX_LOBES = 3
#: Margins from the arena's edges (theta and phi in degrees, the near and
#: far r in cm) and the range floor's decay length in cm: the source's 3, 3,
#: 20 and 30 cells and 25 cells at the default arena.
MARGINS = (12.0, 6.0, 40.0, 60.0)
FLOOR_CM = 50.0
#: Voxels drawn at once: a block's float32 temporaries are 1 GiB each.
BLOCK_VOXELS = 1 << 28


def block_of(arena: Arena) -> int:
    """Scans of `arena` drawn at once."""
    X, Y, Z = arena.shape
    return max(1, BLOCK_VOXELS // (X * Y * Z))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw_targets(gen: torch.Generator, counts: torch.Tensor, slots: int, classes: Sequence[str],
                 arena: Arena):
    """Per scan, `counts[b]` targets in the first slots: (cells (B, T, 3)
    int64, class index (B, T) int64, valid (B, T) bool). Cells keep the
    program's source's margins from the arena's edges."""
    B, dev = counts.shape[0], counts.device
    X, Y, Z = arena.shape
    mt, mp, m_near, m_far = MARGINS
    mx, my = min(round(mt / arena.theta_res), X // 3), min(round(mp / arena.phi_res), Y // 3)
    k_lo = min(round(m_near / arena.r_res), Z // 4)
    k_hi = Z - min(round(m_far / arena.r_res), Z // 3)
    lo = torch.tensor([mx, my, k_lo], device=dev)
    hi = torch.tensor([X - mx, Y - my, max(k_hi, k_lo + 1)], device=dev)
    u = torch.rand((B, slots, 3), generator=gen, device=dev, dtype=torch.float64)
    cells = torch.minimum(lo + (u * (hi - lo)).long(), hi - 1)
    cls = torch.randint(0, len(classes), (B, slots), generator=gen, device=dev)
    valid = torch.arange(slots, device=dev)[None, :] < counts[:, None]
    return cells, cls, valid


def render(gen: torch.Generator, cells: torch.Tensor, cls: torch.Tensor, valid: torch.Tensor,
           classes: Sequence[str], arena: Arena, noise_level: float,
           out: torch.Tensor = None) -> torch.Tensor:
    """(B, X, Y, Z) uint8 scans of the targets (cells, cls, valid), into
    `out` where given."""
    B, T = cls.shape
    dev = cls.device
    X, Y, Z = arena.shape
    cells_per = torch.tensor([1 / arena.theta_res, 1 / arena.phi_res, 1 / arena.r_res, 1.0, 1.0,
                              1 / arena.r_res], dtype=torch.float32, device=dev)
    sig = torch.tensor([SIGNATURES[c] for c in classes], dtype=torch.float32, device=dev)
    t_sd, p_sd, r_sd, amp, lobes, gap = (sig * cells_per)[cls].unbind(-1)  # each (B, T), cells
    ax = [torch.arange(n, device=dev, dtype=torch.float32) for n in (X, Y, Z)]
    c = cells.float()
    gx = torch.exp(-(ax[0] - c[..., 0, None]) ** 2 / (2 * t_sd[..., None] ** 2))
    gx = gx * valid[..., None]
    gy = torch.exp(-(ax[1] - c[..., 1, None]) ** 2 / (2 * p_sd[..., None] ** 2))
    gz = torch.zeros((B, T, Z), device=dev)
    for lobe in range(MAX_LOBES):
        centre = c[..., 2] + lobe * gap
        weight = amp * 0.85 ** lobe * (lobe < lobes)
        gz += weight[..., None] * torch.exp(-(ax[2] - centre[..., None]) ** 2
                                            / (2 * r_sd[..., None] ** 2))
    xy = (gx[..., :, None] * gy[..., None, :]).reshape(B, T, X * Y)
    cube = torch.bmm(xy.transpose(1, 2), gz).view(B, X, Y, Z)
    noise = torch.empty_like(cube).exponential_(1.0 / noise_level, generator=gen)
    cube += noise
    cube += 12.0 * torch.exp(-ax[2] * arena.r_res / FLOOR_CM)
    out = torch.empty((B, X, Y, Z), dtype=torch.uint8, device=dev) if out is None else out
    return out.copy_(cube.clamp_(0.0, 255.0).round_())


def scan_batch(gen: torch.Generator, batch: int, slots: int, classes: Sequence[str],
               arena: Arena, noise_level: float,
               out: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """One batch of `batch` scans: (cubes (B, X, Y, Z) uint8, target cm
    (B, T, 3) float32 at the cells' grid nodes, valid (B, T) bool, class
    (B, T)). Scans hold 1..slots targets: every count equally often,
    in an order drawn from `gen`, so each seed does the same work."""
    dev = gen.device
    counts = torch.arange(batch, device=dev) % slots + 1
    counts = counts[torch.randperm(batch, generator=gen, device=dev)]
    cells, cls, valid = draw_targets(gen, counts, slots, classes, arena)
    X, Y, Z = arena.shape
    cubes = torch.empty((batch, X, Y, Z), dtype=torch.uint8, device=dev) if out is None else out
    block = block_of(arena)
    for s in range(0, batch, block):
        e = min(batch, s + block)
        render(gen, cells[s:e], cls[s:e], valid[s:e], classes, arena, noise_level, cubes[s:e])
    xyz = arena.node_xyz(*cells.unbind(-1)).float()
    return cubes, xyz, valid, cls


def plane_voxels(cells: torch.Tensor, valid: torch.Tensor, arena: Arena) -> int:
    """Voxels that the valid targets' three planes cover, each voxel of a
    scan counted once however many of its targets' planes hold it."""
    B, T = valid.shape
    X, Y, Z = arena.shape
    total, block = 0, block_of(arena)
    for s in range(0, B, block):
        c, v = cells[s:s + block], valid[s:s + block]
        mask = torch.zeros((c.shape[0], X, Y, Z), dtype=torch.bool, device=c.device)
        rows = torch.arange(c.shape[0], device=c.device)
        for t in range(T):
            b, (i, j, k) = rows[v[:, t]], c[v[:, t], t].unbind(-1)
            mask[b, i] = True
            mask[b, :, j] = True
            mask[b, :, :, k] = True
        total += int(mask.sum())
    return total

"""Batch augmentations, counterparts of `uformer_tpu/data/augment.py`:

  * the 8 dihedral ops (reference Augment_RGB_torch), per sample;
  * MixUp with lam ~ Beta(1.2, 1.2) and a random pairing, over the
    global batch of the data ranks.

Every draw comes from the `torch.Generator` passed in, never from a global
RNG. `torch.distributions.Beta` takes no generator, so lam comes from a
numpy Generator seeded by a draw from it.
"""

from __future__ import annotations

import numpy as np
import torch

from uformer_tpu_torch.device import to_device_async


def dihedral_transform(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dihedral op k in [0, 8) of one (H, W, C) image: 0 identity, 1-3
    rot90 x1-3, 4 flip, 5-7 rot90 x1-3 then flip (flips H)."""
    if not 0 <= k < 8:
        raise ValueError(f"dihedral op {k} outside [0, 8)")
    y = torch.rot90(x, k % 4, (0, 1)) if k % 4 else x
    return torch.flip(y, (0,)) if k >= 4 else y


def random_dihedral_batch(generator: torch.Generator, *arrays: torch.Tensor):
    """The same random dihedral op per sample applied to all arrays
    (B, H, W, C), H == W (paired ground truth and input move together)."""
    B = arrays[0].shape[0]
    ks = torch.randint(0, 8, (B,), generator=generator,
                       device=generator.device).tolist()
    out = tuple(torch.stack([dihedral_transform(a[i], k)
                             for i, k in enumerate(ks)]) for a in arrays)
    return out if len(out) > 1 else out[0]


def mixup_apply(target: torch.Tensor, inp: torch.Tensor, lam: torch.Tensor,
                perm: torch.Tensor):
    """lam (B,) in [0, 1], perm a permutation of the batch: each sample
    becomes lam * itself + (1 - lam) * its partner, target and input
    alike. lam and perm drawn on the host reach the card without a stream
    sync."""
    lam = to_device_async(lam.float(), target.device).reshape(-1, 1, 1, 1)
    perm = to_device_async(perm, target.device)
    return (lam * target + (1 - lam) * target[perm],
            lam * inp + (1 - lam) * inp[perm])


def mixup_batch(generator: torch.Generator, target: torch.Tensor,
                inp: torch.Tensor, alpha: float = 1.2, group=None):
    """Pairwise MixUp of (target, input) with lam ~ Beta(alpha, alpha)
    (reference MixUp_AUG.aug). Returns the mixed (target, input).

    With a process group of n > 1 data ranks, target and inp are this
    rank's rows of the global batch: lam and the pairing are drawn for the
    global batch (every rank's generator in one state), the rows come from
    every rank (`parallel.multihost.all_gather_rows`) and this rank keeps
    its mixed rows, as JAX's one program permutes its global batch
    (`uformer_tpu/data/augment.py:48-60`)."""
    from uformer_tpu_torch.parallel.multihost import (
        all_gather_rows,
        group_rank,
        group_size,
    )

    n = group_size(group) if group is not None else 1
    local = target.shape[0]
    B = local * n
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    lam = torch.from_numpy(np.random.default_rng(seed).beta(alpha, alpha, B))
    perm = torch.randperm(B, generator=generator, device=generator.device)
    if n == 1:
        return mixup_apply(target, inp, lam, perm)
    rows = slice(group_rank(group) * local, (group_rank(group) + 1) * local)
    t, i = mixup_apply(all_gather_rows(target, group),
                       all_gather_rows(inp, group), lam, perm)
    return t[rows], i[rows]

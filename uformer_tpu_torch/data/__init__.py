"""The training data: paired datasets and their native (C++) plane,
batch iteration and the prefetch to the card, SIDD patch generation, and
the batch augmentations (dihedral ops, MixUp)."""

from uformer_tpu_torch.data.augment import random_crop_pair  # noqa: F401

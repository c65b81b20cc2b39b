"""The training data: paired datasets and their native (C++) plane,
batch iteration and the prefetch to the card, SIDD patch generation, and
the batch augmentations (dihedral ops, MixUp)."""

"""Batch augmentations of the training data."""

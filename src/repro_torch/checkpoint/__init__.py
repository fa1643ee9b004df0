"""Checkpointing: one .npy per leaf, atomic commit."""

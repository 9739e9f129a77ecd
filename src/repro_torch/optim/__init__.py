"""Functional optimizers on nested dicts of tensors."""

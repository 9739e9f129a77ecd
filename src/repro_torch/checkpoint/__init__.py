"""Checkpoints of parameter and state trees (npz + JSON)."""

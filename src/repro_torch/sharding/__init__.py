"""Partition-spec rules: which mesh axes each parameter and activation
dimension is laid over (pure shape logic; no devices)."""

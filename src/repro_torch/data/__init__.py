"""Datasets and client partitions (numpy only; bitwise copies of the
reference's `repro.data.synthetic` and `repro.data.partition`)."""

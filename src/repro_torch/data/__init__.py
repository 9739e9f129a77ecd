"""Datasets, client partitions and batch pipelines (numpy only; bitwise
copies of the reference's `repro.data.synthetic`, `repro.data.partition`
and `repro.data.pipeline`)."""

"""The synthetic data pipeline of the port: a copy of the numpy-only
reference, so that a shard gives the same batches in both packages."""

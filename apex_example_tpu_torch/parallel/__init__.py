"""Parallel building blocks of the port: SyncBatchNorm (one device for now)."""

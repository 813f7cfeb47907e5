"""Observability pieces of the port (metrics, JSONL sink)."""

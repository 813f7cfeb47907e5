"""Synthetic data of the port (language-model batches from numpy)."""

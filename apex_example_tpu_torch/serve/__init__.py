"""Continuous-batching serving of the port: request queue, synthetic load,
block-paged KV pool, engine, and the CLI (``python -m
apex_example_tpu_torch.serve``, in cli.py)."""

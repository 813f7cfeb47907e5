"""Flax GPT parameters -> the port's GPTForCausalLM state dict.

``gpt_params_from_flax(tree)`` takes the flax param tree of
apex_example_tpu's GPTForCausalLM as nested dicts of numpy arrays (the
caller turns jax arrays into numpy; this module imports no jax) and returns
a state dict for ``GPTForCausalLM.load_state_dict``.  A flax Dense
``kernel`` is [in, out]; it is TRANSPOSED into ``nn.Linear.weight``
[out, in].  Embedding tables, LayerNorm ``scale``/``bias`` and ``lm_bias``
carry over as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = ("attention/query", "attention/key", "attention/value",
          "attention/output", "intermediate", "output")
_NORMS = ("attention_ln", "output_ln")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _node(tree: Mapping, path: str) -> Mapping:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def gpt_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    sd = {
        "word_embeddings.weight": _tensor(
            tree["word_embeddings"]["embedding"]),
        "position_embeddings.weight": _tensor(
            tree["position_embeddings"]["embedding"]),
        "lm_bias": _tensor(tree["lm_bias"]),
    }
    for ln in ("embeddings_ln", "final_ln"):
        sd[f"{ln}.scale"] = _tensor(tree[ln]["scale"])
        sd[f"{ln}.bias"] = _tensor(tree[ln]["bias"])
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    for i in range(n_layers):
        layer = tree[f"layer_{i}"]
        for path in _DENSE:
            dense = _node(layer, path)
            name = f"layers.{i}.{path.replace('/', '.')}"
            sd[f"{name}.weight"] = _tensor(dense["kernel"]).T.contiguous()
            sd[f"{name}.bias"] = _tensor(dense["bias"])
        for ln in _NORMS:
            sd[f"layers.{i}.{ln}.scale"] = _tensor(layer[ln]["scale"])
            sd[f"layers.{i}.{ln}.bias"] = _tensor(layer[ln]["bias"])
    return sd

"""Flax parameters -> the port's state dicts.

``gpt_params_from_flax(tree)``, ``bert_params_from_flax(tree)`` and
``txl_params_from_flax(tree)`` take the flax param tree of
apex_example_tpu's GPTForCausalLM / BertForMaskedLM / TransformerXL as
nested dicts of numpy arrays (the caller turns jax arrays into numpy; this
module imports no jax) and return a state dict for the port model's
``load_state_dict``.  A flax Dense ``kernel`` is [in, out]; it is
TRANSPOSED into ``nn.Linear.weight`` [out, in].  Embedding tables,
LayerNorm ``scale``/``bias``, ``lm_bias``, ``mlm_bias`` and Transformer-XL's
``u_bias``/``v_bias`` carry over as they are: as fp32, but Transformer-XL's
each in its stored dtype (half parameters under amp O3).

``resnet_params_from_flax(params, batch_stats)`` does the same for the
ResNet (models/resnet.py, whose submodules carry the flax names): a conv
``kernel`` [kh, kw, in, out] (HWIO) becomes ``weight`` [out, in, kh, kw]
(OIHW), the Dense ``fc`` kernel is transposed into ``fc.weight``, BatchNorm
``scale``/``bias`` are parameters and the batch statistics ``mean``/``var``
buffers of the same names.

``norm_params_from_flax(variables)`` turns a flax FusedLayerNorm's or
FusedRMSNorm's variables into the port module's state dict, each leaf in
its stored dtype.

``optimizer_state_from_jax(name, state, leaves)`` turns the state of the
JAX package's FusedSGD, FusedNovoGrad or FusedAdagrad into the
``load_state_dict`` form of the port's optimizer of the same name.

``zero_state_from_jax(state, params, to_port, names, world)`` maps the
flat ``mu`` and ``nu`` of the JAX package's ``ZeroAdamState`` (the leaves
of the params tree flattened in ``tree_leaves`` order, sorted keys) onto
the port's DistributedFusedAdam order (``parameters()`` order, each in
the port's layout), padded as the port pads them.

``flax_module_name(name)`` goes the other way for a name alone: the top
level key of the flax tree that holds the port's parameter ``name``
(``layers.3.attention.query.weight`` -> ``layer_3``; ``mlm_bias``,
``word_emb.weight``, ``Bottleneck_3.conv1.weight`` -> their first part),
the module names of ``--numerics-check``'s records (obs/numerics.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

_DENSE = ("attention/query", "attention/key", "attention/value",
          "attention/output", "intermediate", "output")
_NORMS = ("attention_ln", "output_ln")


def flax_module_name(name: str) -> str:
    """The flax tree's top-level key of the port's parameter ``name``."""
    head, _, rest = name.partition(".")
    if head == "layers":
        return f"layer_{rest.partition('.')[0]}"
    return head


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _node(tree: Mapping, path: str) -> Mapping:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _layers_from_flax(tree: Mapping, sd: Dict[str, torch.Tensor]) -> None:
    """The shared post-LN layers ``layer_i`` and the embedding tables."""
    sd["word_embeddings.weight"] = _tensor(
        tree["word_embeddings"]["embedding"])
    sd["position_embeddings.weight"] = _tensor(
        tree["position_embeddings"]["embedding"])
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


def _stored(a) -> torch.Tensor:
    """``a`` as a tensor of its own dtype.  A bfloat16 array (ml_dtypes',
    which ``torch.from_numpy`` does not take) crosses as its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _norm_leaves(node: Mapping, convert=_tensor) -> Dict[str, torch.Tensor]:
    """A flax FusedLayerNorm's or FusedRMSNorm's leaves: ``scale`` and
    ``bias``, each where the module has it (``use_scale``, ``use_bias``)."""
    return {k: convert(node[k]) for k in ("scale", "bias") if k in node}


def _norms(tree: Mapping, names, sd: Dict[str, torch.Tensor],
           prefix: str = "") -> None:
    for ln in names:
        for leaf, t in _norm_leaves(tree[ln]).items():
            sd[f"{prefix}{ln}.{leaf}"] = t


def norm_params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``FusedLayerNorm`` / ``FusedRMSNorm`` from
    the flax module's variables (``{"params": {...}}``, or the params
    alone; numpy leaves): ``scale`` and, where present, ``bias``, in their
    stored dtype.  A module built with ``use_scale=False`` (and
    ``use_bias=False``) has no leaf and gets an empty dict."""
    return _norm_leaves(variables.get("params", variables), _stored)


def gpt_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    sd = {"lm_bias": _tensor(tree["lm_bias"])}
    _norms(tree, ("embeddings_ln", "final_ln"), sd)
    _layers_from_flax(tree, sd)
    return sd


def bert_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """BertForMaskedLM: the GPT layout's embeddings and layers, plus
    ``mlm_dense`` (transposed), ``mlm_ln`` and ``mlm_bias``; the decoder
    is the word-embedding table itself."""
    sd = {"mlm_bias": _tensor(tree["mlm_bias"]),
          "mlm_dense.weight": _tensor(
              tree["mlm_dense"]["kernel"]).T.contiguous(),
          "mlm_dense.bias": _tensor(tree["mlm_dense"]["bias"])}
    _norms(tree, ("embeddings_ln", "mlm_ln"), sd)
    _layers_from_flax(tree, sd)
    return sd


def txl_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """TransformerXL: ``word_emb/embedding``; per layer ``attn/{q,k,v,r,o}``
    (bias-free, transposed), ``attn/u_bias``, ``attn/v_bias``, ``attn_ln``,
    ``ff1``, ``ff2`` (transposed, with biases) and ``ff_ln``, each leaf in
    its stored dtype: the model's ``param_dtype`` (half under amp O3), the
    LayerNorms' fp32."""
    sd = {"word_emb.weight": _stored(tree["word_emb"]["embedding"])}
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    for i in range(n_layers):
        layer, name = tree[f"layer_{i}"], f"layers.{i}"
        attn = layer["attn"]
        for proj in ("q", "k", "v", "r", "o"):
            sd[f"{name}.attn.{proj}.weight"] = _stored(
                attn[proj]["kernel"]).T.contiguous()
        for bias in ("u_bias", "v_bias"):
            sd[f"{name}.attn.{bias}"] = _stored(attn[bias])
        for ff in ("ff1", "ff2"):
            sd[f"{name}.{ff}.weight"] = _stored(
                layer[ff]["kernel"]).T.contiguous()
            sd[f"{name}.{ff}.bias"] = _stored(layer[ff]["bias"])
        for ln in ("attn_ln", "ff_ln"):
            for leaf, t in _norm_leaves(layer[ln], _stored).items():
                sd[f"{name}.{ln}.{leaf}"] = t
    return sd


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def resnet_params_from_flax(params: Mapping, batch_stats: Mapping = None
                            ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ResNet from the flax ``params`` and
    ``batch_stats`` trees (numpy leaves), fp32."""
    sd = {}
    for path, leaf in _flatten(params):
        module, _, name = path.rpartition(".")
        t = _tensor(leaf)
        if name == "kernel":
            name = "weight"
            t = (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T)
        sd[f"{module}.{name}"] = t.contiguous()
    for path, leaf in _flatten(batch_stats or {}):
        sd[path] = _tensor(leaf)
    return sd


# The JAX optimizer state's fields and the port's names for them.
_OPT_FIELDS = {"sgd": {"momentum": "momentum_buffer"},
               "novograd": {"mu": "mu", "nu": "nu"},
               "adagrad": {"sum_sq": "sum_sq"}}


def _map_trees(fn, a, b):
    """``fn`` over the leaves of two nested dicts of one structure."""
    if isinstance(a, Mapping):
        return {k: _map_trees(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def optimizer_state_from_jax(name: str, state: Mapping,
                             leaves: Callable[[Mapping], List]) -> Dict:
    """The port's optimizer state dict from a JAX ``SGDState``,
    ``NovoGradState`` or ``AdagradState`` (``name``: sgd, novograd or
    adagrad).  ``state`` maps the state's fields to numpy: ``step`` a
    scalar, the others nested dicts shaped as the flax params.  ``leaves``
    turns such a tree into the port's parameters' order, with the layout of
    each (for example a ``*_params_from_flax`` converter, then its values
    in the model's ``named_parameters`` order), so that a moment of a
    transposed kernel is transposed with it.  NovoGrad's ``nu`` holds one
    scalar per leaf: each goes through ``leaves`` as an array of the
    parameter's shape filled with it, and comes out 0-d."""
    if name not in _OPT_FIELDS:
        raise ValueError(f"no JAX optimizer state named {name!r}: "
                         f"{sorted(_OPT_FIELDS)}")
    out = {"step": int(np.asarray(state["step"]))}
    for field, port_name in _OPT_FIELDS[name].items():
        tree = state[field]
        if field == "nu":
            tree = _map_trees(lambda m, s: np.full(np.shape(m), s, np.float32),
                              state["mu"], tree)
        tensors = [torch.from_numpy(np.array(t, np.float32))
                   for t in leaves(tree)]
        if field == "nu":
            tensors = [t.reshape(-1)[0].clone() for t in tensors]
        out[port_name] = [t.contiguous() for t in tensors]
    return out


def _unflatten_like(flat: np.ndarray, tree: Mapping, offset: List[int]
                    ) -> Dict:
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out[key] = _unflatten_like(flat, value, offset)
        else:
            size = int(np.size(value))
            out[key] = flat[offset[0]:offset[0] + size].reshape(
                np.shape(value))
            offset[0] += size
    return out


def zero_state_from_jax(state: Mapping, params: Mapping,
                        to_port: Callable[[Mapping], Mapping[str,
                                                             torch.Tensor]],
                        names: List[str], world: int) -> Dict:
    """``{"step", "mu", "nu"}`` of a JAX ``ZeroAdamState`` (numpy leaves;
    ``mu`` and ``nu`` whole, of every shard) in the port's flat order:
    ``params`` is the flax params tree whose leaves the state flattens,
    ``to_port`` a ``*_params_from_flax`` converter, ``names`` the port
    model's parameter names in ``parameters()`` order.  ``mu`` and ``nu``
    come out fp32, padded to a multiple of ``world * 128`` as the port's
    DistributedFusedAdam pads them; process r's shard is the r-th of
    ``world`` equal pieces."""
    out = {"step": int(np.asarray(state["step"]))}
    for field in ("mu", "nu"):
        flat = np.asarray(state[field], np.float32)
        sd = to_port(_unflatten_like(flat, params, [0]))
        port = torch.cat([sd[name].reshape(-1).float() for name in names])
        n = port.numel()
        out[field] = torch.cat([port, torch.zeros((-n) % (world * 128))])
    return out

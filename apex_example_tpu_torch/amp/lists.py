"""amp op-classification lists and their registration API: a copy of
apex_example_tpu/amp/lists.py (pure Python, kept here so the port imports
nothing of the JAX package).

The whitelist (run in the half dtype: conv, matmul, ...), the blacklist
(run in fp32: softmax, norms, losses, ...) and the promote list (mixed
inputs take the widest dtype), keyed by op-class names that the port's
modules consult at their boundaries (amp/autocast.py), plus apex's
``register_{half,float,promote}_function`` extension points, which mutate
the same tables.  ``INT8_FUNCS`` and ``quant_classify`` belong to the
quantization slice; they are copied with the rest of the module.
"""

from __future__ import annotations

# Run in the half compute dtype (where the FLOPs are).
FP16_FUNCS = {
    "conv", "conv1d", "conv2d", "conv3d", "conv_transpose",
    "dense", "linear", "matmul", "mm", "bmm", "addmm", "einsum",
    "attention_scores", "attention_context", "embedding",
}

# Run in fp32 (numerically sensitive: large reductions, exp/log families,
# losses, normalization statistics).
FP32_FUNCS = {
    "softmax", "log_softmax", "batch_norm", "sync_batch_norm", "layer_norm",
    "group_norm", "instance_norm", "cross_entropy", "nll_loss", "mse_loss",
    "exp", "log", "pow", "sum", "mean", "var", "std", "norm", "cumsum",
    "softplus", "sigmoid_focal_loss", "gelu_fp32",
}

# Mixed-dtype inputs are promoted to the widest participating dtype.
PROMOTE_FUNCS = {
    "add", "sub", "mul", "div", "addcmul", "addcdiv", "cat", "stack",
    "where", "residual_add",
}

# Op classes whose weights may drop to int8/fp8 for serving.
INT8_FUNCS = {
    "conv", "conv1d", "conv2d", "conv3d", "conv_transpose",
    "dense", "linear", "matmul", "mm", "bmm", "addmm", "einsum",
    "embedding",
}


def register_half_function(name: str) -> None:
    """apex's ``amp.register_half_function``: add an op class to the
    whitelist."""
    _move(name, FP16_FUNCS)


def register_float_function(name: str) -> None:
    _move(name, FP32_FUNCS)


def register_promote_function(name: str) -> None:
    _move(name, PROMOTE_FUNCS)


def register_quant_function(name: str) -> None:
    """Mark an op class's weights as int8/fp8-eligible; orthogonal to the
    half/float compute tables."""
    INT8_FUNCS.add(name)


def _move(name: str, target: set) -> None:
    for s in (FP16_FUNCS, FP32_FUNCS, PROMOTE_FUNCS):
        s.discard(name)
    target.add(name)


def classify(name: str) -> str:
    """'half' | 'float' | 'promote' | 'none' for an op-class name."""
    if name in FP16_FUNCS:
        return "half"
    if name in FP32_FUNCS:
        return "float"
    if name in PROMOTE_FUNCS:
        return "promote"
    return "none"


def quant_classify(name: str) -> str:
    """'quant' | 'keep': may this op class's weights drop to int8/fp8?
    FP32_FUNCS membership wins over an INT8_FUNCS entry."""
    if name in FP32_FUNCS:
        return "keep"
    return "quant" if name in INT8_FUNCS else "keep"

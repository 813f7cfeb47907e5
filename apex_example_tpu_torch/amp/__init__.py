"""apex.amp's surface over the port's policy engine: port of
apex_example_tpu/amp/__init__.py.

``initialize`` returns a :class:`Policy` and a :class:`ScalerState`; the
caller threads the policy's dtypes into model construction
(:func:`module_dtypes`) and the scaler into the train step
(engine.make_train_step).
"""

from apex_example_tpu_torch.amp.autocast import (ModuleDtypes, cast_args,
                                                 disable_casts,
                                                 module_dtypes, op_dtype)
from apex_example_tpu_torch.amp.lists import (quant_classify,
                                              register_float_function,
                                              register_half_function,
                                              register_promote_function,
                                              register_quant_function)
from apex_example_tpu_torch.amp.policy import (Policy, get_policy,
                                               opt_level_table)
from apex_example_tpu_torch.amp.scaler import (ScalerState, load_state_dict,
                                               make_scaler, scale_loss,
                                               state_dict, unscale_grads)
from apex_example_tpu_torch.amp.scaler import update as update_scaler

__all__ = [
    "ModuleDtypes", "Policy", "ScalerState", "cast_args", "disable_casts",
    "get_policy", "initialize", "load_state_dict", "make_scaler",
    "module_dtypes", "op_dtype", "opt_level_table", "quant_classify",
    "register_float_function", "register_half_function",
    "register_promote_function", "register_quant_function", "scale_loss",
    "state_dict", "unscale_grads", "update_scaler",
]


def initialize(opt_level: str = "O0", loss_scale=None,
               keep_batchnorm_fp32=None, half_dtype=None,
               init_scale: float = 2.0 ** 16, growth_interval: int = 2000,
               device="cpu"):
    """apex's ``amp.initialize``: ``(policy, scaler)``, the scaler's
    tensors on ``device``.  ``half_dtype`` (default bf16) picks the reduced
    dtype; fp16 is chosen here, not on the command line."""
    import torch
    policy = get_policy(opt_level, loss_scale=loss_scale,
                        keep_batchnorm_fp32=keep_batchnorm_fp32,
                        half_dtype=half_dtype or torch.bfloat16)
    return policy, make_scaler(policy, init_scale=init_scale,
                               growth_interval=growth_interval,
                               device=device)

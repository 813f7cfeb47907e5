"""The JAX side of the port's tests, made cheap without changing what it
computes.

A flax ``init`` or the JAX ``create_train_state`` run eagerly compiles
every op of the model's forward on its own, and under the Pallas
interpreter traces each kernel too.  ``flax_init`` and ``create_state``
are one ``jax.jit`` each, on the kernels' XLA reference forms
(``ops._config.force_xla``).  The parameters are the init's, bit for bit:
the forward only gives their shapes, and both sides of a test start from
what these return.  ``KernelScope`` keeps an optimizer on its Pallas
kernels, or off them, whichever the rest of a step traces on.
"""

import functools

import jax

from apex_example_tpu.engine import create_train_state
from apex_example_tpu.ops import _config as ops_config


def flax_init(module, *args, **kw):
    """``module.init(*args, **kw)``: ``args`` arrays, ``kw`` static."""
    with ops_config.force_xla(True):
        return jax.jit(functools.partial(module.init, **kw))(*args)


def create_state(rng, model, optimizer, sample_batch, policy, scaler=None,
                 train_kwargs=None):
    """The JAX ``create_train_state`` with these arguments."""
    def build(key, batch):
        return create_train_state(key, model, optimizer, batch, policy,
                                  scaler, train_kwargs)
    with ops_config.force_xla(True):
        return jax.jit(build)(rng, sample_batch)


class KernelScope:
    """A JAX optimizer whose ``apply`` traces on its kernels' XLA forms
    (``xla=True``) or on its Pallas kernels (``xla=False``), whichever
    the rest of the step traces on: a trail keeps the interpreted kernels
    only where its tolerance needs their rounding."""

    def __init__(self, optimizer, xla):
        self.optimizer, self.xla = optimizer, xla

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def apply(self, *args):
        with ops_config.force_xla(self.xla):
            return self.optimizer.apply(*args)

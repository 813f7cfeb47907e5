"""DistributedFusedAdam, ZeRO-1 over the data-parallel group: port of
apex_example_tpu/optim/distributed.py (``DistributedFusedAdam`` :83,
``make_zero_train_step`` :211).  The JAX ``ZeroAdamState`` (:53: step,
mu, nu) is the optimizer's ``step_count`` and its shards ``mu`` and
``nu``.

Adam whose moments are sharded over the processes: the parameters are
flattened, in ``parameters()`` order, into one fp32 buffer padded to a
multiple of ``world * 128``, and process r keeps the moments of elements
``[r * padded / world, (r + 1) * padded / world)`` only, 1/world of
FusedAdam's state.  A step, as the JAX step on its engine path
(:163-207):

    flat_g   = all_reduce(flatten(grads))        # the JAX engine's psum
    unscale flat_g (the scale kernel and its flag, under a loss scaler)
    g_shard  = flat_g[shard] / world             # the mean
    flag     = all_reduce_max(any non-finite in g_shard)
    p_shard  = Adam kernel (p, g, m, v of the shard), skipped on the flag
    flat_p   = all_reduce(p_shard in place, zeros elsewhere)
    params   = unflatten(flat_p)

The shard's Adam step is the port's Adam kernel (ops/fused_optim.py
``adam_cuda``) over a table of one tensor each of p, g, m and v, built once
over buffers that stay put.  The step count lives on the card and each
step's (lr, c1, c2) is a row of a device table that the count indexes, as
FusedAdam's (optim/fused.py), and the flag is reduced over the group
before the kernel reads it: every process steps, or none does, so the
gathered parameters stay equal.  A skipped step leaves the parameters,
the moments and the count.  The JAX optimizer reduce-scatters grads that
are each device's own; on its engine path they arrive summed, and it
slices them, which is what this port does.

On the CPU the shard steps through ``adam_update_plain``.  The gather is
a sum of disjoint slices, JAX's form of the all-gather (:200-207); the
port uses ``all_reduce`` and ``broadcast`` only.

The state dict is FusedAdam's, per parameter (``step``, ``mu``, ``nu``), so
a checkpoint does not depend on the world it was written in:
``state_dict`` gathers the shards (every process of the group calls it,
a collective) and strips the padding; ``load_state_dict`` takes this
process's slice ``[lo, lo + shard)`` of the flattened moments.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.ops.fused_optim import (adam_cuda,
                                                    adam_update_plain)
from apex_example_tpu_torch.ops.multi_tensor import (
    TensorTable, multi_tensor_l2norm_cuda, multi_tensor_l2norm_plain,
    multi_tensor_scale_cuda, multi_tensor_scale_plain)
from apex_example_tpu_torch.optim.fused import Schedule, _AdamScalars
from apex_example_tpu_torch.parallel.distributed import (all_reduce_max,
                                                         reduce_mean,
                                                         replicate_mean)
from apex_example_tpu_torch.parallel.mesh import DATA_AXIS, group_of

LANES = 128


def padded_size(n: int, world: int) -> int:
    """``n`` rounded up to a multiple of ``world * 128`` (:65)."""
    return n + (-n) % (world * LANES)


class DistributedFusedAdam(_AdamScalars):
    """ZeRO-1 Adam/AdamW over a list of parameters, updated in place in
    every process of ``axis_name``'s group.  The constructor mirrors
    FusedAdam's and the JAX one's (the world is the group's size); the
    summed grads are divided by the world, the mean-reduction contract."""

    sharded_state = True     # state_dict() is a collective of the group

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True, *,
                 axis_name=DATA_AXIS):
        self.params = list(params)
        if not self.params:
            raise ValueError("DistributedFusedAdam needs at least one "
                             "parameter")
        self.device = self.params[0].device
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay, self.adam_w_mode = weight_decay, adam_w_mode
        self.axis_name = axis_name
        group = group_of(axis_name)
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        numel = sum(p.numel() for p in self.params)
        self.padded = padded_size(numel, self.world)
        self.shard = self.padded // self.world
        self.lo = self.rank * self.shard
        with torch.no_grad():
            for p in self.params:
                if p.device != self.device:
                    raise ValueError(f"a parameter lies on {p.device}, "
                                     f"another on {self.device}")
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.flat_g = torch.zeros(self.padded, **f32)
        self.flat_p = torch.zeros(self.padded, **f32)
        self.mu = torch.zeros(self.shard, **f32)
        self.nu = torch.zeros(self.shard, **f32)
        sizes = [p.numel() for p in self.params]
        self._g_views = [v.view(p.shape) for v, p in zip(
            self.flat_g[:numel].split(sizes), self.params)]
        self._p_views = [v.view(p.shape) for v, p in zip(
            self.flat_p[:numel].split(sizes), self.params)]
        self.tables = []
        if self.device.type != "cpu":      # the kernels, or their refusal
            self.tables = [TensorTable([[self.p_shard], [self.g_shard],
                                        [self.mu], [self.nu]])]
            self._flat_table = TensorTable([[self.flat_g]])
        self._init_step_count(True)

    @property
    def p_shard(self) -> torch.Tensor:
        return self.flat_p[self.lo:self.lo + self.shard]

    @property
    def g_shard(self) -> torch.Tensor:
        return self.flat_g[self.lo:self.lo + self.shard]

    @property
    def grads(self):
        return [p.grad for p in self.params]

    def zero_grad(self) -> None:
        """Zero every grad in place."""
        with torch.no_grad():
            torch._foreach_zero_(self.grads)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Flatten the grads into ``flat_g`` (fp32) and sum them over the
        group: the JAX engine's psum."""
        torch._foreach_copy_(self._g_views, self.grads)
        dist.all_reduce(self.flat_g, group=group_of(self.axis_name))

    @torch.no_grad()
    def unscale_grads(self, inv_scale: torch.Tensor) -> torch.Tensor:
        """``flat_g *= inv_scale`` (0-d fp32 on the device) in place; a 0-d
        int32 flag, 1 where an element is not finite.  One scale launch on
        the card."""
        if not self.tables:
            out, finite = multi_tensor_scale_plain([self.flat_g], inv_scale,
                                                   flag_output=True)
            self.flat_g.copy_(out[0])
            return (~finite).to(torch.int32)
        return multi_tensor_scale_cuda(self._flat_table, 0, 0,
                                       scale_t=inv_scale, flag_output=True)

    def grad_norm(self) -> torch.Tensor:
        """The L2 norm of ``flat_g`` (0-d fp32): after :meth:`reduce_grads`
        the norm of the summed grads, which is the JAX ZeRO step's
        ``grad_norm`` (world x the mean's).  One L2-norm launch on the
        card."""
        if not self.tables:
            return multi_tensor_l2norm_plain([self.flat_g])[0]
        return multi_tensor_l2norm_cuda(self._flat_table)[0]

    @torch.no_grad()
    def step(self, noop_flag: Optional[torch.Tensor] = None) -> None:
        """The sharded step over the grads reduced into ``flat_g``
        (:meth:`reduce_grads`), then the gather of the parameters.
        ``noop_flag``: a 0-d int32 on the device, nonzero to skip (the
        loss scaler's); the shard's own non-finite flag, reduced over the
        group, skips too."""
        scal = self._begin_step()
        torch._foreach_copy_(self._p_views, self.params)
        g = self.g_shard
        g.div_(self.world)                       # the mean-reduction contract
        bad = all_reduce_max((~torch.isfinite(g).all()).to(torch.int32),
                             self.axis_name)
        noop = bad if noop_flag is None else torch.maximum(bad, noop_flag)
        hyper = dict(beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                     weight_decay=self.weight_decay,
                     adam_w_mode=self.adam_w_mode)
        if self.tables:
            adam_cuda(self.tables[0], scalars_t=scal, noop_flag=noop, **hyper)
        else:
            lr, c1, c2 = scal
            keep = noop != 0
            outs = adam_update_plain(self.p_shard, g, self.mu, self.nu, lr=lr,
                                     bias_c1=c1, bias_c2=c2, **hyper)
            for dst, src in zip((self.p_shard, self.mu, self.nu), outs):
                dst.copy_(torch.where(keep, dst, src))
        self._count_step(noop)
        self._gather()

    def _gather(self) -> None:
        """Every process's shard into every process's parameters: a sum
        of the shards, each in its place with zeros elsewhere."""
        hi = self.lo + self.shard
        self.flat_p[:self.lo].zero_()
        self.flat_p[hi:].zero_()
        dist.all_reduce(self.flat_p, group=group_of(self.axis_name))
        torch._foreach_copy_(self.params, self._p_views)

    @torch.no_grad()
    def state_dict(self) -> Dict:
        """FusedAdam's per-parameter state dict: the shards of ``mu`` and
        ``nu`` gathered over the group (one all-reduce of both), the
        padding stripped.  Every process of the group must call it."""
        full = torch.zeros(2, self.padded, dtype=torch.float32,
                           device=self.device)
        full[0, self.lo:self.lo + self.shard] = self.mu
        full[1, self.lo:self.lo + self.shard] = self.nu
        dist.all_reduce(full, group=group_of(self.axis_name))
        sizes = [p.numel() for p in self.params]
        numel = sum(sizes)
        out = {"step": self.step_count}
        for row, name in enumerate(("mu", "nu")):
            out[name] = [v.view(p.shape) for v, p in zip(
                full[row, :numel].split(sizes), self.params)]
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy this process's slice of a per-parameter state dict (from
        this optimizer at any world, or from FusedAdam) into the shards,
        in place, and set the step count."""
        sizes = [p.numel() for p in self.params]
        for name in ("mu", "nu"):
            got = [t.numel() for t in state[name]]
            if got != sizes:
                raise ValueError(f"state's {name} holds {len(got)} tensors "
                                 f"of {sum(got)} elements, the optimizer "
                                 f"{len(sizes)} of {sum(sizes)}")
        numel = sum(sizes)
        hi = min(self.lo + self.shard, numel)
        for name in ("mu", "nu"):
            shard = getattr(self, name)
            shard.zero_()
            if hi > self.lo:
                flat = torch.cat([t.reshape(-1).float() for t in state[name]])
                shard[:hi - self.lo].copy_(flat[self.lo:hi])
        self.step_count = int(state["step"])


def make_zero_train_step(loss_fn: Optional[Callable] = None,
                         compute_accuracy: bool = True):
    """The data-parallel step with ZeRO-1 state (:211): ``train_step(state,
    (x, y)) -> (state, metrics)`` with ``state.optimizer`` a
    :class:`DistributedFusedAdam`, in every process of its group on that
    process's rows of the global batch.  The grads are summed in the
    optimizer (``reduce_grads``), unscaled with the loss scaler's flag,
    and stepped by the sharded optimizer; the loss and top-1 are averaged
    over the group, and so are the model's running statistics.  Metrics
    as engine.make_train_step's; ``grad_norm`` is the summed grads' (the
    JAX ZeRO step's)."""
    from apex_example_tpu_torch.engine import batch_top1, cross_entropy_loss
    loss_fn = loss_fn or cross_entropy_loss

    def train_step(state, batch) -> Tuple[object, Dict]:
        x, y = batch
        opt, scaler = state.optimizer, state.scaler
        axis = opt.axis_name
        state.model.train()
        opt.zero_grad()
        logits = state.model(x)
        loss = loss_fn(logits, y)
        amp.scale_loss(loss, scaler).backward()
        opt.reduce_grads()
        found_inf = amp.unscale_grads(opt, scaler)
        grad_norm = opt.grad_norm()
        opt.step(noop_flag=found_inf)
        state.scaler = amp.update_scaler(scaler, found_inf)
        state.step += 1
        metrics = {"loss": reduce_mean(loss, axis),
                   "scale": state.scaler.scale,
                   "grads_finite": (1.0 if found_inf is None
                                    else (found_inf == 0).float()),
                   "grad_norm": grad_norm}
        if compute_accuracy and torch.is_tensor(y):
            metrics["top1"] = reduce_mean(batch_top1(logits.detach(), y),
                                          axis)
        replicate_mean(list(state.model.buffers()), axis)
        return state, metrics

    return train_step

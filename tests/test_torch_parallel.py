"""The port's data parallelism held against the JAX package's, on the CPU:
two gloo processes (tests/torch_dist_cases.py, started once for the
module, a FileStore under tmp_path, one torch thread each, every wait
bounded) against JAX ``shard_map`` on 2 of the 8 CPU devices
(tests/conftest.py), on the same numpy inputs and weights (flax trees
from numpy, converted by convert.py).  JAX's SyncBatchNorm runs its
Pallas kernels interpreted; its train steps run the kernels' XLA
reference forms (``ops._config.force_xla``), as the interpreter would
take ~45 s more of this file's budget (the kernels themselves are held
against the port's in tests/test_torch_optim.py and the like):

- SyncBatchNorm, composite and fused branches (2 x 4 rows of 3 x 3 x 6):
  y, the running statistics, dx, dscale and dbias (each rank's dscale
  and dbias summed over the ranks, as the step's average over them makes
  them the full batch's, times the world) against full-batch BatchNorm in
  one process and against JAX's SyncBatchNorm under shard_map, whose
  grads of its replicated parameters come summed: 1e-5 rtol and atol
  (fp32 sums over 72 rows in another order);
- ``allreduce_grads`` (average, pre-divide 2, bf16, bf16 reduced in fp32,
  int8 with 8-element chunks, alone and pre-divided) against JAX's
  ``allreduce_grads`` on per-device grads: equal bit for bit (two addends
  round alike in any order; the int8 sums are integers), and the int8
  result within ``world * scale / 2`` of the exact sum; apex's
  ``DistributedDataParallel``, ``Reducer`` and ``broadcast_from_zero``
  bit for bit against the same sums and rank 0's values;
- two DDP steps of a ResNet (two stages of one BasicBlock, 4 filters,
  16 px, global batch 8) with SyncBatchNorm and FusedSGD, two of gpt_tiny
  (one layer, FusedAdam) and two of transformer_xl_tiny (one layer, the
  clip, its memory carried, split on its batch axis) against JAX's
  ``make_sharded_train_step`` / ``make_sharded_txl_train_step`` and
  against one process taking the whole batch, and the ResNet's with LARC
  against the whole batch (LARC's step against JAX's alone): losses,
  grad norms and the parameters after the trail rtol 1e-4, atol 1e-4
  (fp32, sums in another order, compounding); both ranks' parameters
  equal bit for bit; gpt_tiny's and transformer_xl_tiny's trails at
  ``grad_accum=2`` (each rank's rows in 2 microbatches, one all-reduce a
  step) against one process at ``grad_accum=2`` on the whole batch,
  within the same limits, the memory's rows too;
- the data-parallel step in a group of one process against the plain
  step, at O0 and O2: equal bit for bit;
- the CLI under torchrun at world 2 on the CPU (``--sync_bn``): exit 0,
  one header, from rank 0;
- the trainer with ``--zero --opt adam`` in the two processes: one epoch,
  a checkpoint and ``--resume`` for the second against two epochs
  without a break, the final checkpoints equal bit for bit; with
  ``--metrics-all-ranks`` both ranks' streams lint;
- the data-parallel refusals carry the JAX trainer's messages.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_cases as cases
from apex_example_tpu import amp as jamp
from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.engine import TrainState as JaxTrainState
from apex_example_tpu.engine import make_sharded_train_step as jax_ddp_step
from apex_example_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_example_tpu.models.resnet import BasicBlock as JaxBasicBlock
from apex_example_tpu.models.resnet import ResNet as JaxResNet
from apex_example_tpu.models.transformer_xl import \
    transformer_xl_tiny as jax_txl_tiny
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.optim.fused import FusedAdam as JaxAdam
from apex_example_tpu.optim.fused import FusedSGD as JaxSGD
from apex_example_tpu.parallel import DDPConfig as JaxDDPConfig
from apex_example_tpu.parallel import LARC as JaxLARC
from apex_example_tpu.parallel import SyncBatchNorm as JaxSyncBatchNorm
from apex_example_tpu.parallel import allreduce_grads as jax_allreduce
from apex_example_tpu.parallel import make_data_mesh
from apex_example_tpu.workloads import lm_loss as jax_lm_loss
from apex_example_tpu.workloads import \
    make_sharded_txl_train_step as jax_ddp_txl_step
from apex_example_tpu_torch import train
from apex_example_tpu_torch.convert import (gpt_params_from_flax,
                                            resnet_params_from_flax,
                                            txl_params_from_flax)
from apex_example_tpu_torch.data.synthetic import image_batch, lm_batch
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.resnet import ResNet
from apex_example_tpu_torch.models.transformer_xl import transformer_xl_tiny
from apex_example_tpu_torch.optim.fused import FusedAdam, FusedSGD
from apex_example_tpu_torch.parallel import LARC, SyncBatchNorm
from apex_example_tpu_torch.workloads import lm_loss, make_txl_train_step

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

import train as jax_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BN_TOL = 1e-5
TRAIL_TOL = 1e-4
IMG, IMG_B, IMG_STEPS = 16, 8, 2
LM_B, LM_S, LM_STEPS, V = 4, 16, 2, 256
CASES = ["syncbn_composite", "syncbn_fused", "allreduce", "ddp_resnet",
         "ddp_resnet_larc", "ddp_gpt", "ddp_txl", "ddp_accum_gpt",
         "ddp_accum_txl", "zero_resume"]


def flax_numpy(tree_fn, seed, he=False):
    """Weights of a flax model's variables from numpy (``jax.eval_shape``
    gives the tree, the init never runs): kernels normal over sqrt(fan
    in) (He's sqrt(2 / fan in) for ``he``), embeddings 0.02 normal,
    scales and variances 1 + 0.05 normal, everything else 0.05 normal."""
    tree = jax.eval_shape(tree_fn)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = np.sqrt((2.0 if he else 1.0) / np.prod(shape[:-1]))
            return (rs.randn(*shape) * std).astype(np.float32)
        if name == "embedding":
            return (0.02 * rs.randn(*shape)).astype(np.float32)
        base = 1.0 if name in ("scale", "var") else 0.0
        return (base + 0.05 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _jax_resnet(axis=None):
    return JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock,
                     num_classes=10, num_filters=4, small_stem=True,
                     bn_axis_name=axis)


def _to_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _spec():
    rs = np.random.RandomState(0)
    bn_x = rs.randn(8, 3, 3, 6).astype(np.float32) * 2 + 0.5
    bn_w = rs.randn(8, 3, 3, 6).astype(np.float32)
    bn_sd = {"scale": 1 + 0.1 * rs.randn(6), "bias": 0.1 * rs.randn(6),
             "mean": 0.2 * rs.randn(6), "var": 1 + 0.1 * rs.rand(6)}
    bn_sd = {k: v.astype(np.float32) for k, v in bn_sd.items()}
    shapes = [(5, 3), (7,), (2, 3, 4), (16,)]
    grads = [(rs.randn(WORLD, *s) * 10.0 ** rs.randint(-2, 2)).astype(
        np.float32) for s in shapes]
    resnet = flax_numpy(lambda: _jax_resnet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False),
        1, he=True)
    gpt = flax_numpy(lambda: jax_gpt_tiny(num_layers=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, LM_S), jnp.int32)), 2)
    txl = flax_numpy(lambda: jax_txl_tiny(num_layers=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, LM_S), jnp.int32)), 3)
    img = [tuple(a.numpy() for a in image_batch(
        i, batch_size=IMG_B, image_size=IMG, num_classes=10, seed=0,
        device="cpu")) for i in range(IMG_STEPS)]
    lm = []
    for i in range(LM_STEPS):
        toks = lm_batch(i, batch_size=LM_B, seq_len=LM_S, vocab_size=V,
                        seed=0)
        lm.append((np.ascontiguousarray(toks[:, :-1]),
                   np.ascontiguousarray(toks[:, 1:])))
    return {"cases": CASES, "bn_x": bn_x, "bn_w": bn_w, "bn_sd": bn_sd,
            "grads": grads, "img_batches": img, "lm_batches": lm,
            "resnet_flax": resnet, "gpt_flax": gpt["params"],
            "txl_flax": txl["params"],
            "resnet_sd": _to_numpy(resnet_params_from_flax(
                resnet["params"], resnet["batch_stats"])),
            "gpt_sd": _to_numpy(gpt_params_from_flax(gpt["params"])),
            "txl_sd": _to_numpy(txl_params_from_flax(txl["params"]))}


# ---------------------------------------------------------------- JAX side

def _mesh():
    return make_data_mesh(devices=jax.devices()[:WORLD])


def _jax_syncbn(spec, fused):
    mod = JaxSyncBatchNorm(use_running_average=False, axis_name="data",
                           fused_kernel=fused)
    sd = {k: jnp.asarray(v) for k, v in spec["bn_sd"].items()}
    params = {"scale": sd["scale"], "bias": sd["bias"]}
    stats = {"mean": sd["mean"], "var": sd["var"]}

    def per_device(params, xs, ws):
        def loss(p, xs):
            y, mut = mod.apply({"params": p, "batch_stats": stats}, xs,
                               mutable=["batch_stats"])
            return jnp.sum(y * ws), (y, mut["batch_stats"])
        (gp, gx), (y, st) = jax.grad(loss, argnums=(0, 1),
                                     has_aux=True)(params, xs)
        return y, st, gx, gp

    f = jax.jit(shard_map(per_device, mesh=_mesh(),
                          in_specs=(P(), P("data"), P("data")),
                          out_specs=(P("data"), P(), P("data"), P())))
    y, st, gx, gp = f(params, jnp.asarray(spec["bn_x"]),
                      jnp.asarray(spec["bn_w"]))
    return {"y": y, "mean": st["mean"], "var": st["var"], "dx": gx,
            "dscale": gp["scale"], "dbias": gp["bias"]}


JAX_ALLREDUCE = {
    "average": (JaxDDPConfig(), jnp.float32),
    "predivide": (JaxDDPConfig(gradient_predivide_factor=2.0), jnp.float32),
    "bf16": (JaxDDPConfig(), jnp.bfloat16),
    "fp32_bf16": (JaxDDPConfig(allreduce_always_fp32=True), jnp.bfloat16),
    "int8": (JaxDDPConfig(quantized_allreduce=True, quant_chunk=8),
             jnp.float32),
    "int8_predivide": (JaxDDPConfig(quantized_allreduce=True, quant_chunk=8,
                                    gradient_predivide_factor=2.0),
                       jnp.float32)}


def _jax_allreduce(spec):
    out = {}
    for name, (cfg, dtype) in JAX_ALLREDUCE.items():
        def per_device(*gs, cfg=cfg):
            red = jax_allreduce([g[0] for g in gs], cfg, "data",
                                already_reduced=False)
            return tuple(g[None] for g in red)
        n = len(spec["grads"])
        f = jax.jit(shard_map(per_device, mesh=_mesh(),
                              in_specs=(P("data"),) * n,
                              out_specs=(P("data"),) * n))
        res = f(*[jnp.asarray(g).astype(dtype) for g in spec["grads"]])
        out[name] = [np.asarray(r, np.float32) for r in res]
    return out


def _jax_state(params, stats, opt, policy):
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=opt.init(params),
                         scaler=jamp.make_scaler(policy))


def _jax_trail(step, state, batches, mems=None):
    metrics, all_mems = [], []
    for x, y in batches:
        if mems is None:
            state, met = step(state, (jnp.asarray(x), jnp.asarray(y)))
        else:
            state, mems, met = step(state, mems,
                                    (jnp.asarray(x), jnp.asarray(y)))
            all_mems.append(np.asarray(mems))
        metrics.append({k: float(v) for k, v in met.items()})
    return state, metrics, all_mems


def _jax_resnet_trail(spec):
    policy = get_policy("O0")
    v = spec["resnet_flax"]
    opt = JaxSGD(**cases.SGD)
    step = jax_ddp_step(_mesh(), _jax_resnet("data"), opt, policy,
                        donate=False)
    state, metrics, _ = _jax_trail(
        step, _jax_state(v["params"], v["batch_stats"], opt, policy),
        spec["img_batches"])
    sd = resnet_params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))
    return metrics, _to_numpy(sd)


def _jax_gpt_trail(spec):
    policy = get_policy("O0")
    opt = JaxAdam(**cases.ADAM)
    step = jax_ddp_step(_mesh(), jax_gpt_tiny(num_layers=1), opt, policy,
                        loss_fn=jax_lm_loss, compute_accuracy=False,
                        donate=False)
    state, metrics, _ = _jax_trail(
        step, _jax_state(spec["gpt_flax"], {}, opt, policy),
        spec["lm_batches"])
    return metrics, _to_numpy(gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)))


def _jax_txl_trail(spec):
    policy = get_policy("O0")
    opt = JaxAdam(**cases.ADAM)
    model = jax_txl_tiny(num_layers=1)
    step = jax_ddp_txl_step(_mesh(), model, opt, policy, max_grad_norm=0.25,
                            donate=False)
    state, metrics, mems = _jax_trail(
        step, _jax_state(spec["txl_flax"], {}, opt, policy),
        spec["lm_batches"], mems=model.init_mems(LM_B))
    return metrics, _to_numpy(txl_params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))), mems


# ------------------------------------------------- one process, whole batch

def _full_syncbn(spec, fused):
    m = SyncBatchNorm(6, fused_kernel=fused, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in
                       spec["bn_sd"].items()})
    x = torch.from_numpy(spec["bn_x"]).requires_grad_()
    y = m(x)
    (y * torch.from_numpy(spec["bn_w"])).sum().backward()
    return {"y": y, "mean": m.mean, "var": m.var, "dx": x.grad,
            "dscale": m.scale.grad, "dbias": m.bias.grad}


def _full_trail(model, opt, step, batches, mems=None):
    state = create_train_state(model, opt)
    metrics, all_mems = [], []
    for x, y in batches:
        if mems is None:
            state, met = step(state, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        else:
            state, mems, met = step(state, mems, (torch.from_numpy(x),
                                                  torch.from_numpy(y)))
            all_mems.append(mems.numpy())
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, _to_numpy({k: v.detach() for k, v in
                               model.state_dict().items()}), all_mems


def _full_resnet(spec, larc):
    model = ResNet(**cases.RESNET, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["resnet_sd"].items()})
    if larc:
        opt = LARC(FusedSGD(model.parameters(), lr=cases.LARC_LR,
                            momentum=0.9, weight_decay=0.0),
                   trust_coefficient=cases.LARC_TRUST, lr=cases.LARC_LR,
                   weight_decay=cases.LARC_WD)
    else:
        opt = FusedSGD(model.parameters(), **cases.SGD)
    return _full_trail(model, opt, make_train_step(),
                       spec["img_batches"])[:2]


def _full_lm(spec, txl, grad_accum=1):
    build = transformer_xl_tiny if txl else gpt_tiny
    model = build(**cases.LM, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           spec["txl_sd" if txl else "gpt_sd"].items()})
    opt = FusedAdam(model.parameters(), **cases.ADAM)
    if txl:
        return _full_trail(model, opt, make_txl_train_step(
            0.25, grad_accum=grad_accum), spec["lm_batches"],
            mems=model.init_mems(LM_B))
    return _full_trail(model, opt, make_train_step(
        lm_loss, compute_accuracy=False, grad_accum=grad_accum),
        spec["lm_batches"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the two ranks and the torchrun CLI, compute the JAX and
    whole-batch references meanwhile, then collect the ranks."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    spec = _spec()
    spec["zero_resume_dir"] = str(tmp_path_factory.mktemp("zero_resume"))
    ranks = cases.Ranks(spec, tmp_path_factory.mktemp("ranks"), WORLD)
    cli_dir = tmp_path_factory.mktemp("cli")
    stream = cli_dir / "run.jsonl"
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "apex_example_tpu_torch.train",
         "--device", "cpu", "--arch", "resnet18", "--sync_bn",
         "--batch-size", "8", "--steps-per-epoch", "2", "--print-freq", "1",
         "--metrics-jsonl", str(stream)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        ref = {"jax": {}, "full": {}}
        for fused in (False, True):
            name = "syncbn_fused" if fused else "syncbn_composite"
            ref["jax"][name] = _jax_syncbn(spec, fused)
            ref["full"][name] = _full_syncbn(spec, fused)
        ref["jax"]["allreduce"] = _jax_allreduce(spec)
        with jax_ops_config.force_xla(True):
            ref["jax"]["ddp_resnet"] = _jax_resnet_trail(spec)
            ref["jax"]["ddp_gpt"] = _jax_gpt_trail(spec)
            ref["jax"]["ddp_txl"] = _jax_txl_trail(spec)
        for larc in (False, True):
            name = "ddp_resnet_larc" if larc else "ddp_resnet"
            ref["full"][name] = _full_resnet(spec, larc)
        ref["full"]["ddp_gpt"] = _full_lm(spec, txl=False)
        ref["full"]["ddp_txl"] = _full_lm(spec, txl=True)
        for txl in (False, True):
            ref["full"]["ddp_accum_txl" if txl else "ddp_accum_gpt"] = \
                _full_lm(spec, txl, grad_accum=2)
        results = ranks.results()
        out, _ = cli.communicate(timeout=240)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait(timeout=30)
        torch.set_num_threads(before)
    return spec, ref, results, (cli.returncode, out, stream)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("branch", ["syncbn_composite", "syncbn_fused"])
def test_syncbn_matches_full_batch_and_jax(run, branch):
    spec, ref, results, _ = run
    got = [r[branch] for r in results]
    merged = {"y": np.concatenate([g["y"] for g in got]),
              "dx": np.concatenate([g["dx"] for g in got]),
              "dscale": sum(g["dscale"] for g in got),
              "dbias": sum(g["dbias"] for g in got),
              "mean": got[0]["mean"], "var": got[0]["var"]}
    for key in ("mean", "var"):          # every rank's statistics equal
        np.testing.assert_array_equal(got[0][key], got[1][key])
    for side in ("full", "jax"):
        want = ref[side][branch]
        for key, value in merged.items():
            _close(value, np.asarray(
                want[key].detach() if torch.is_tensor(want[key])
                else want[key]), BN_TOL, f"{branch} {key} vs {side}")
    # each rank's dscale is its own rows' share, not the sum
    assert not np.allclose(got[0]["dscale"], merged["dscale"], rtol=1e-3)


def test_allreduce_grads_matches_jax_bit_for_bit(run):
    spec, ref, results, _ = run
    want = ref["jax"]["allreduce"]
    for name in want:
        for r in range(WORLD):
            for got, exp in zip(results[r]["allreduce"][name], want[name]):
                np.testing.assert_array_equal(got, exp[r], err_msg=name)
    # apex's facades: DDP's constructor options, the Reducer's sum and
    # rank 0's values broadcast
    for r in range(WORLD):
        got = results[r]["allreduce"]
        for a, b in zip(got["ddp_predivide"], got["predivide"]):
            np.testing.assert_array_equal(a, b)
        for a, g in zip(got["reducer_sum"], spec["grads"]):
            np.testing.assert_array_equal(a, g[0] + g[1])
        for a, g in zip(got["broadcast"], spec["grads"]):
            np.testing.assert_array_equal(a, g[0])
    # the sum the average divides, exactly, and int8's bound
    exact = [g.astype(np.float64).sum(0) / WORLD for g in spec["grads"]]
    for got, e in zip(results[0]["allreduce"]["average"], exact):
        np.testing.assert_allclose(got, e, rtol=1e-6)
    for name, pre in (("int8", 1.0), ("int8_predivide", 2.0)):
        for got, g in zip(results[0]["allreduce"][name], spec["grads"]):
            flat = (g.reshape(WORLD, -1) / pre).astype(np.float32)
            pad = (-flat.shape[1]) % 8
            chunks = np.pad(flat, ((0, 0), (0, pad))).reshape(WORLD, -1, 8)
            scale = np.maximum(np.abs(chunks).max(-1).max(0) / 127.0, 1e-30)
            bound = np.repeat(WORLD * scale / 2, 8)[:flat.shape[1]]
            total = flat.astype(np.float64).sum(0)
            err = np.abs(got.reshape(-1) * WORLD / pre - total)
            assert np.all(err <= bound * (1 + 1e-6) + 1e-12), name


@pytest.mark.parametrize("name", ["ddp_resnet", "ddp_resnet_larc",
                                  "ddp_gpt", "ddp_txl"])
def test_ddp_trail_matches_jax_and_the_whole_batch(run, name):
    spec, ref, results, _ = run
    got = results[0][name]
    for key, value in got["sd"].items():       # every rank holds the same
        np.testing.assert_array_equal(value, results[1][name]["sd"][key],
                                      err_msg=key)
    # LARC's update against JAX's: test_larc_step_matches_jax
    for side in ("full",) if name == "ddp_resnet_larc" else ("jax", "full"):
        metrics, sd = ref[side][name][:2]
        for step, (g, w) in enumerate(zip(got["metrics"], metrics)):
            for key in ("loss", "grad_norm", "ppl", "top1"):
                if key in w:
                    _close(g[key], w[key], TRAIL_TOL,
                           f"{name} step {step} {key} vs {side}")
        for key, value in sd.items():
            _close(got["sd"][key], value, TRAIL_TOL, f"{name} {key} vs {side}")
    start = spec["resnet_sd" if "resnet" in name else
                 "gpt_sd" if "gpt" in name else "txl_sd"]
    moved = max(float(np.abs(got["sd"][k] - start[k]).max()) for k in start)
    assert moved > 10 * TRAIL_TOL               # the trail moved the weights
    if name == "ddp_txl":                       # each rank's memory rows
        for step in range(LM_STEPS):
            mems = np.concatenate([r[name]["mems"][step] for r in results],
                                  axis=1)
            for side in ("jax", "full"):
                _close(mems, ref[side][name][2][step], TRAIL_TOL,
                       f"memory step {step} vs {side}")


@pytest.mark.parametrize("name", ["ddp_accum_gpt", "ddp_accum_txl"])
def test_ddp_grad_accum_equals_one_process_at_k_2(run, name):
    """Each rank's 2 rows in 2 microbatches, the grads all-reduced once on
    their mean, against one process taking the whole batch in 2: the
    same trail (fp32 sums in another order), and the memory's rows."""
    _, ref, results, _ = run
    got = results[0][name]
    for key, value in got["sd"].items():
        np.testing.assert_array_equal(value, results[1][name]["sd"][key],
                                      err_msg=key)
    metrics, sd, mems = ref["full"][name]
    for step, (g, w) in enumerate(zip(got["metrics"], metrics)):
        for key in ("loss", "grad_norm", "ppl"):
            if key in w:
                _close(g[key], w[key], TRAIL_TOL, f"{name} {step} {key}")
    for key, value in sd.items():
        _close(got["sd"][key], value, TRAIL_TOL, f"{name} {key}")
    for step, want in enumerate(mems):
        _close(np.concatenate([r[name]["mems"][step] for r in results],
                              axis=1), want, TRAIL_TOL,
               f"{name} memory step {step}")


def test_torchrun_cli_at_world_2(run):
    rc, out, stream = run[3]
    assert rc == 0, out
    assert out.count("model resnet18:") == 1, out
    assert "data parallel: world 2, backend gloo, device cpu, " \
           "SyncBatchNorm" in out
    assert "epoch 0 step 2/2" in out
    records = [json.loads(ln) for ln in stream.read_text().splitlines()]
    kinds = [r["record"] for r in records]                  # rank 0's only
    assert kinds.count("run_header") == 1 and kinds.count("step") == 2


def test_zero_resume_is_bitwise_and_every_rank_writes_its_stream(run):
    """--zero --opt adam: 1 epoch, a checkpoint, --resume for the second,
    against 2 epochs without a break; both final checkpoints (FusedAdam's
    per-parameter moments, gathered from the shards) equal bit for bit.
    With --metrics-all-ranks, PATH and PATH.rank1 both lint."""
    spec, _, results, _ = run
    for r in results:
        assert r["zero_resume"]["rcs"] == [0, 0, 0]
    out = results[0]["zero_resume"]["out"]
    assert "resumed from step 2 (epoch 1)" in out
    assert "saved checkpoint at step 4" in out
    got, want = (results[0]["zero_resume"][k] for k in ("broken", "whole"))
    assert got["state"] == want["state"] and want["state"]["step"] == 4
    assert got["optimizer"]["step"] == want["optimizer"]["step"] == 4
    for name in ("mu", "nu"):
        for i, (g, w) in enumerate(zip(got["optimizer"][name],
                                       want["optimizer"][name])):
            assert torch.equal(g, w), f"{name}[{i}]"
    for name, w in want["model"].items():
        assert torch.equal(got["model"][name], w), name
    sizes = [t.numel() for t in want["model"].values()]
    assert [t.numel() for t in want["optimizer"]["mu"]] == sizes
    stream = os.path.join(spec["zero_resume_dir"], "run.jsonl")
    headers = []
    for path in (stream, stream + ".rank1"):
        lint = subprocess.run(
            [sys.executable, "tools/metrics_lint.py", path,
             "--require-summary"], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert lint.returncode == 0, lint.stdout + lint.stderr
        with open(path) as fh:
            headers.append(json.loads(fh.readline()))
    assert [h["process_index"] for h in headers] == [0, 1]
    assert all(h["num_processes"] == WORLD for h in headers)


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_ddp_step_at_world_1_is_the_plain_step_bit_for_bit(tmp_path, level):
    """In a group of one process the data-parallel step (SyncBatchNorm's
    all-reduces, the grads' all-reduce, the averages) does the plain
    step's arithmetic: the file's ResNet at ``level``, one step of its
    first batch, loss, grad norm and parameters equal bit for bit."""
    import torch.distributed as dist
    from apex_example_tpu_torch import amp
    from apex_example_tpu_torch.engine import make_sharded_train_step
    from apex_example_tpu_torch.parallel import (convert_syncbn_model,
                                                 make_data_mesh)
    x, y = image_batch(0, batch_size=IMG_B, image_size=IMG, num_classes=10,
                       seed=0, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        out = []
        for ddp in (False, True):
            policy, scaler = amp.initialize(level, device="cpu")
            md = amp.module_dtypes(policy)
            model = ResNet(**cases.RESNET, dtype=md.compute,
                           param_dtype=md.param, bn_dtype=md.bn_stats,
                           bn_io_dtype=md.bn_io, seed=0, device="cpu")
            state = create_train_state(
                model, FusedSGD(model.parameters(), **cases.SGD), policy,
                scaler)
            if ddp:
                mesh = make_data_mesh()
                convert_syncbn_model(model, mesh)
                step = make_sharded_train_step(mesh)
            else:
                step = make_train_step()
            state, met = step(state, (x, y))
            out.append((float(met["loss"]), float(met["grad_norm"]),
                        [p.detach() for p in model.parameters()]))
    finally:
        dist.destroy_process_group()
    (loss, norm, params), (d_loss, d_norm, d_params) = out
    assert (d_loss, d_norm) == (loss, norm)
    for p, d in zip(params, d_params):
        assert torch.equal(p, d)


def _jax_message(fn):
    with pytest.raises(SystemExit) as exc:
        fn()
    return str(exc.value)


def _args(argv):
    return train.build_parser().parse_args(["--device", "cpu"] + argv)


def _jax_args(**kw):
    base = dict(larc=False, opt="adam", grad_accum=1,
                gradient_predivide_factor=1.0, lr=0.1, lr_schedule="const",
                epochs=1, steps_per_epoch=1, warmup_steps=0,
                lr_decay_epochs="", lr_gamma=0.1, lr_min=0.0,
                weight_decay=0.0)
    base.update(kw)
    return Namespace(**base)


@pytest.mark.parametrize("argv,jax_kw", [
    (["--zero", "--grad-accum", "2"], dict(grad_accum=2)),
    (["--zero", "--larc"], dict(larc=True)),
    (["--zero", "--opt", "sgd"], dict(opt="sgd")),
    (["--zero", "--gradient-predivide-factor", "2"],
     dict(gradient_predivide_factor=2.0))])
def test_zero_refusals_carry_the_jax_messages(argv, jax_kw):
    port = _jax_message(lambda: train.check_parallel_args(
        _args(["--opt", "adam"] + argv), 2))
    want = _jax_message(lambda: jax_train.build_zero_optimizer(
        _jax_args(**jax_kw), 2))
    assert port == want


def test_zero_at_world_1_and_txl_and_the_batch_carry_the_jax_messages():
    port = _jax_message(lambda: train.main(
        ["--device", "cpu", "--arch", "resnet18", "--opt", "adam", "--zero",
         "--batch-size", "2", "--steps-per-epoch", "1"]))
    assert port == _jax_message(lambda: jax_train.build_zero_optimizer(
        _jax_args(), 1))
    port = _jax_message(lambda: train.check_parallel_args(
        _args(["--arch", "transformer_xl_tiny", "--opt", "adam", "--zero"]),
        2))
    assert port == _jax_message(lambda: jax_train.main(
        ["--arch", "transformer_xl_tiny", "--opt", "adam", "--zero"]))
    port = _jax_message(lambda: train.check_parallel_args(
        _args(["--batch-size", "7"]), 2))
    assert port == _jax_message(lambda: jax_train.select_devices(
        Namespace(num_devices=2, batch_size=7)))


def test_quant_core_matches_jax_compiled():
    """quant/core.py against the JAX package's under jax.jit (as its DDP
    step compiles it): per-row max-abs scales for int8 and fp8, the int8
    grid, its dequantization and the fp8 cast, bit for bit, an all-zero
    row included (SCALE_EPS)."""
    import functools
    from apex_example_tpu.quant import core as jq
    from apex_example_tpu_torch.quant import core as tq
    rs = np.random.RandomState(5)
    x = (rs.randn(64, 33) * 10.0 ** rs.randint(-3, 3, (64, 1))).astype(
        np.float32)
    x[5] = 0.0
    for qmax in (jq.INT8_QMAX, jq.FP8_QMAX):
        want = np.asarray(jax.jit(functools.partial(
            jq.abs_max_scale, axis=1, qmax=qmax))(jnp.asarray(x)))
        got = tq.abs_max_scale(torch.from_numpy(x), dim=1, qmax=qmax)
        np.testing.assert_array_equal(got.numpy(), want)
    scale = tq.abs_max_scale(torch.from_numpy(x), dim=1)
    q = tq.quantize_int8(torch.from_numpy(x), scale)
    jqq = jax.jit(jq.quantize_int8)(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(
        tq.dequantize(q, scale).numpy(),
        np.asarray(jax.jit(jq.dequantize)(jqq, jnp.asarray(scale))))
    assert np.all(np.abs(tq.dequantize(q, scale).numpy() - x)
                  <= scale.numpy() / 2 * (1 + 1e-6))
    s8 = tq.abs_max_scale(torch.from_numpy(x), dim=1, qmax=tq.FP8_QMAX)
    f8, emulated = tq.quantize_fp8(torch.from_numpy(x), s8)
    j8, _ = jax.jit(jq.quantize_fp8)(jnp.asarray(x), jnp.asarray(s8))
    assert f8.dtype == torch.float8_e4m3fn and not emulated
    np.testing.assert_array_equal(f8.float().numpy(),
                                  np.asarray(j8).astype(np.float32))


def test_larc_step_matches_jax():
    """Two steps of LARC over FusedSGD (clip mode, weight decay in the
    trust ratio, the inner optimizer without) against the JAX package's
    LARC over its FusedSGD, on tensors that include an all-zero parameter
    and an all-zero grad (ratio 1): the parameters rtol 1e-6 and atol
    1e-7 (fp32; JAX's optax form adds p' - p back to p), and the step's
    return the raw grads' global norm.  JAX's SGD through its XLA
    reference form, as the DDP trails run it."""
    import optax
    rs = np.random.RandomState(7)
    shapes = [(6, 5), (5,), (4, 3, 2), (3,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    params[1][:] = 0.0                              # a fresh bias
    grads = [[(rs.randn(*s) * 10.0 ** rs.randint(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(2)]
    grads[0][3][:] = 0.0                            # a zero grad
    ps = [torch.from_numpy(p.copy()) for p in params]
    larc = LARC(FusedSGD(ps, lr=cases.LARC_LR, momentum=0.9,
                         weight_decay=0.0),
                trust_coefficient=cases.LARC_TRUST, lr=cases.LARC_LR,
                weight_decay=cases.LARC_WD)
    tx = JaxLARC(JaxSGD(lr=cases.LARC_LR, momentum=0.9,
                        weight_decay=0.0).as_optax(),
                 trust_coefficient=cases.LARC_TRUST, lr=cases.LARC_LR,
                 weight_decay=cases.LARC_WD)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    update = jax.jit(tx.update)
    with jax_ops_config.force_xla(True):        # traced on the first call
        update([jnp.zeros_like(p) for p in jp], js, jp)
    for gs in grads:
        with torch.no_grad():
            for p, g in zip(ps, gs):
                p.grad.copy_(torch.from_numpy(g))
        gnorm = larc.step()
        upd, js = update([jnp.asarray(g) for g in gs], js, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(float(gnorm), np.sqrt(sum(
            float((g.astype(np.float64) ** 2).sum()) for g in gs)),
            rtol=1e-6)
        for p, j in zip(ps, jp):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)

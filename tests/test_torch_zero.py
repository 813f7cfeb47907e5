"""The port's ZeRO-1 (optim/distributed.py DistributedFusedAdam and
``make_zero_train_step``) held against the JAX package's on the CPU: two
gloo processes (tests/torch_dist_cases.py ``case_zero``, started once for
the module) against JAX's ``make_zero_train_step`` under ``shard_map`` on
2 of the 8 CPU devices (its Adam kernel through its XLA reference form,
as tests/test_torch_parallel.py runs the steps), from the same numpy
weights of bert_tiny (one layer), MLM batches of 4 x 16, FusedAdam's
hyper-parameters, amp O0 under dynamic loss scaling.

The ranks take a clean step, then a step whose rank 1 plants an inf in
element 0 of the first parameter's grad (a region of rank 0's shard, so
rank 1's own shard stays finite), then that batch again and the next;
the JAX trail takes the three clean steps.

- each rank holds ``padded / 2`` of mu and nu, padded as JAX pads;
- the overflow step is skipped on both ranks: parameters, both shards
  and the count bitwise as before it, the scale halved; so at O2 in fp16
  too (the fp16 dynamic-scaling contract); and under the identity
  scaler, where only the shards' flag, reduced over the ranks, can skip
  it;
- the three clean steps follow JAX: loss and grad norm (the summed
  grads', as the JAX ZeRO step reports it) rtol 1e-4, the parameters
  rtol and atol 1e-4, mu and nu (both ranks' shards, mapped from JAX's
  flat leaf order by convert.zero_state_from_jax) rtol 1e-4 plus 1e-4 of
  the largest magnitude (fp32, sums in another order);
- ``--zero`` through the trainer's command line at world 2 (both
  processes of the group) exits 0, rank 0 alone printing and writing.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from apex_example_tpu.amp.policy import get_policy
from apex_example_tpu.models.bert import bert_tiny as jax_bert_tiny
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu.optim.distributed import DistributedFusedAdam as JaxZero
from apex_example_tpu.optim.distributed import make_zero_train_step
from apex_example_tpu.workloads import mlm_loss as jax_mlm_loss
from apex_example_tpu_torch.convert import (bert_params_from_flax,
                                            zero_state_from_jax)
from apex_example_tpu_torch.data.synthetic import mlm_batch
from apex_example_tpu_torch.models.bert import bert_tiny
from test_torch_parallel import _jax_state, _mesh, _to_numpy, flax_numpy

WORLD, B, S, V = 2, 4, 16, 256
TOL = 1e-4
PORT_CLEAN = [0, 2, 3]          # the port's steps that JAX takes too


def _spec(stream):
    bert = flax_numpy(lambda: jax_bert_tiny(num_layers=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32)), 4)
    batches = []
    for i in range(3):
        ids, labels, w = mlm_batch(i, batch_size=B, seq_len=S, vocab_size=V,
                                   mask_token_id=V - 1, seed=0)
        batches.append((ids, (labels, w)))
    return {"cases": ["zero", "zero_static", "zero_fp16", "zero_cli"],
            "bert_flax": bert["params"],
            "bert_sd": _to_numpy(bert_params_from_flax(bert["params"])),
            "mlm_batches": batches, "zero_cli_stream": str(stream)}


def _jax_zero_trail(spec):
    policy = get_policy("O0", loss_scale="dynamic")
    opt = JaxZero(world=WORLD, **cases.ADAM)
    step = make_zero_train_step(_mesh(), jax_bert_tiny(num_layers=1), opt,
                                policy, loss_fn=jax_mlm_loss,
                                compute_accuracy=False, donate=False)
    state = _jax_state(spec["bert_flax"], {}, opt, policy)
    out = []
    for ids, (labels, w) in spec["mlm_batches"]:
        state, met = step(state, (jnp.asarray(ids), (jnp.asarray(labels),
                                                     jnp.asarray(w))))
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "params": jax.tree_util.tree_map(np.asarray,
                                                     state.params),
                    "opt": jax.tree_util.tree_map(np.asarray,
                                                  state.opt_state)})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    stream = tmp_path_factory.mktemp("cli") / "run.jsonl"
    spec = _spec(stream)
    ranks = cases.Ranks(spec, tmp_path_factory.mktemp("ranks"), WORLD)
    try:
        with jax_ops_config.force_xla(True):
            want = _jax_zero_trail(spec)
        results = ranks.results()
    finally:
        torch.set_num_threads(before)
    got = {name: [r[name] for r in results]
           for name in ("zero", "zero_static", "zero_fp16", "zero_cli")}
    return spec, want, got, stream


def test_each_rank_holds_half_the_state(run):
    spec, want, got, _ = run
    padded = want[0]["opt"].mu.shape[0]
    for r in got["zero"]:
        assert r["padded"] == padded and r["shard"] * WORLD == padded
        for step in r["steps"]:
            assert step["mu"].shape == step["nu"].shape == (r["shard"],)
    n = sum(v.size for v in spec["bert_sd"].values())
    assert padded % (WORLD * 128) == 0 and 0 <= padded - n < WORLD * 128


@pytest.mark.parametrize("name", ["zero", "zero_static", "zero_fp16"])
def test_an_overflow_step_is_skipped_on_every_rank(run, name):
    """Under dynamic scaling (O0, and O2 in fp16) the scaler's flag (the
    summed grads') and the shards' flag both skip; under the identity
    scaler the shards' flag alone, reduced over the ranks: rank 1's own
    shard is finite."""
    _, _, runs, _ = run
    got = runs[name]
    for r in got:
        before, skipped = r["steps"][0], r["steps"][1]
        assert skipped["count"] == before["count"] == 1
        if name != "zero_static":
            assert skipped["metrics"]["grads_finite"] == 0.0
            assert skipped["scale"] == before["scale"] / 2
        else:
            assert skipped["scale"] == before["scale"] == 1.0
        for key in ("mu", "nu"):
            np.testing.assert_array_equal(skipped[key], before[key])
        for key, value in before["sd"].items():
            np.testing.assert_array_equal(skipped["sd"][key], value,
                                          err_msg=key)
        counts = [step["count"] for step in r["steps"]]
        if name == "zero_fp16":
            # fp16 may overflow again at the halved scale: the count
            # follows each step's own flag
            finite = [int(step["metrics"]["grads_finite"])
                      for step in r["steps"]]
            assert counts == list(itertools.accumulate(finite))
        else:
            assert counts[2] == 2                      # the next one steps
    for key, value in got[0]["steps"][-1]["sd"].items():   # still in step
        np.testing.assert_array_equal(got[1]["steps"][-1]["sd"][key], value)


def test_zero_trail_matches_jax(run):
    spec, want, runs, _ = run
    got = runs["zero"]
    model = bert_tiny(num_layers=1, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for j, i in enumerate(PORT_CLEAN):
        w, g = want[j], got[0]["steps"][i]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g["metrics"][key],
                                       w["metrics"][key], rtol=TOL,
                                       err_msg=f"step {j} {key}")
        assert g["count"] == int(w["opt"].step) == j + 1
        params = bert_params_from_flax(w["params"])
        for key, value in g["sd"].items():
            np.testing.assert_allclose(value, params[key].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f"step {j} {key}")
        mapped = zero_state_from_jax(w["opt"]._asdict(), spec["bert_flax"],
                                     bert_params_from_flax, names, WORLD)
        for key in ("mu", "nu"):
            full = np.concatenate([r["steps"][i][key] for r in got])
            exp = mapped[key].numpy()
            np.testing.assert_allclose(full, exp, rtol=TOL,
                                       atol=TOL * np.abs(exp).max(),
                                       err_msg=f"step {j} {key}")
    start = spec["bert_sd"]
    last = got[0]["steps"][-1]["sd"]
    assert max(float(np.abs(last[k] - start[k]).max()) for k in start) \
        > 10 * TOL                                 # the trail moved them


def test_zero_through_the_cli_at_world_2(run):
    """``train.main`` with --zero in both processes of the group: exit 0,
    rank 0 alone prints (the header names ZeRO-1) and writes the
    stream."""
    _, _, got, stream = run
    r0, r1 = got["zero_cli"]
    assert r0["rc"] == r1["rc"] == 0
    assert "ZeRO-1 optimizer state" in r0["out"], r0["out"]
    assert r0["out"].count("model bert_tiny") == 1 and r1["out"] == ""
    steps = [json.loads(ln) for ln in stream.read_text().splitlines()]
    losses = [r["loss"] for r in steps if r["record"] == "step"]
    assert len(losses) == 2 and all(np.isfinite(losses))

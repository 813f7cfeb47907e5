"""Checkpoints and resume in the port (utils/checkpoint.py, the trainer's
``--checkpoint-dir`` / ``--save-every-steps`` / ``--async-checkpoint`` /
``--resume``, and serving's ``--checkpoint-dir`` / ``--checkpoint-step``),
on the CPU at tiny sizes.

- Resume is bitwise: ``train.main`` runs 4 steps (``--steps-per-epoch 3``,
  ``--epochs 2``) without a break, and again as 2 steps with
  ``--save-every-steps 2``, stopped at the next step boundary (an
  exception from the batch source, as a killed process stops), then
  ``--resume`` for 2 more, so the resume falls in the middle of epoch 0.
  The parameters, buffers, the optimizer's moments and step count,
  ``TrainState.step`` and the loss scaler's scale and growth counter are
  bitwise equal after both: bert_tiny with LAMB at O0; gpt_tiny with Adam
  at O2 under ``--loss-scale dynamic`` with step 2's scaled loss times
  1e38, an overflow the scaler skips, so that the optimizer's count (1)
  and the train state's (2) differ in the checkpoint; a ResNet-18 of 4
  filters with SGD and ``--eval`` (BatchNorm statistics restored, the
  same EVAL line); bert_tiny with NovoGrad; transformer_xl_tiny, whose
  memory restarts cold on a resume, against the unbroken run with its
  memory reset at the same step.  The same 4-step runs with
  ``--async-checkpoint`` (bert_tiny, LAMB); with ``--host-pipeline
  --grad-accum 2`` (bert_tiny, LAMB: the native prefetcher restarts at the
  restored step); and a ResNet-18 with ``--host-pipeline --grad-accum 2
  --remat block --eval`` (the same EVAL line from the one-shot stream).
- A restore copies in place: the optimizer's parameters stay the model's,
  every ``data_ptr()`` of parameters, grads and moments and every device
  table pointer (ops/multi_tensor.TensorTable) stays as it was.
- ``save(wait=False)`` snapshots: a step after it does not reach the file.
- ``max_to_keep`` prunes the step directories and the sidecars alike; the
  sidecar equals JAX's ``host_loop_state`` (root train.py :471) for the
  same arguments and step; a missing checkpoint raises FileNotFoundError.
- Serving: ``--checkpoint-step 1`` serves step 1 of two saved steps, the
  same tokens as a model holding step 1's parameters in memory, and
  tokens other than step 2's (the latest, served without the flag) and
  the untrained model's; names and shapes that do not match the serving
  model raise, listed (the model's ``load_state_dict``).
"""

import ast
import contextlib
import functools
import io
import os
import types

import numpy as np
import pytest
import torch

from apex_example_tpu_torch import amp, train
from apex_example_tpu_torch.engine import create_train_state, make_train_step
from apex_example_tpu_torch.models.bert import bert_tiny
from apex_example_tpu_torch.models.gpt import gpt_tiny
from apex_example_tpu_torch.models.resnet import resnet18
from apex_example_tpu_torch.ops.multi_tensor import TensorTable
from apex_example_tpu_torch.optim.fused import FusedLAMB
from apex_example_tpu_torch.serve import cli as serve_cli
from apex_example_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                     restore_params)
from apex_example_tpu_torch.workloads import mlm_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--batch-size", "4", "--seq-len", "16",
        "--steps-per-epoch", "3", "--epochs", "2", "--print-freq", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Stop(Exception):
    """Ends a run at a step boundary, where a killed process would stop."""


def _run(monkeypatch, argv, stop_at, overflow_at=None, reset_mems_at=None):
    """``train.main(argv)`` stopped when it asks for the batch of step
    ``stop_at``; returns the train state and what it printed.  Step
    ``overflow_at``'s scaled loss is multiplied by 1e38; the memory is
    reset to zeros before step ``reset_mems_at``."""
    states = []
    build_state, build_step = train.build_state, train.build_step
    train_batch = train.BatchSource.train
    scale_loss = amp.scale_loss

    def keep_state(args, device):
        states.append(build_state(args, device))
        return states[-1]

    def stopping(source, step):
        if step == stop_at:
            raise _Stop
        return train_batch(source, step)

    def drilled(args):
        step_fn = build_step(args)

        def step(state, *rest):
            if reset_mems_at is not None and state.step + 1 == reset_mems_at:
                rest = (torch.zeros_like(rest[0]),) + rest[1:]
            if overflow_at is None or state.step + 1 != overflow_at:
                return step_fn(state, *rest)
            with monkeypatch.context() as m:
                m.setattr(amp, "scale_loss",
                          lambda loss, s: scale_loss(loss, s) * 1e38)
                return step_fn(state, *rest)
        return step

    out = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(train, "build_state", keep_state)
        m.setattr(train.BatchSource, "train", stopping)
        m.setattr(train, "build_step", drilled)
        with contextlib.redirect_stdout(out), pytest.raises(_Stop):
            train.main(argv)
    return states[-1], out.getvalue()


def _assert_bitwise(got, want):
    gm, wm = got.model.state_dict(), want.model.state_dict()
    assert list(gm) == list(wm)
    for name in wm:
        assert torch.equal(gm[name], wm[name]), name
    go, wo = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert go["step"] == wo["step"] and set(go) == set(wo)
    for name in set(wo) - {"step"}:
        for i, (g, w) in enumerate(zip(go[name], wo[name])):
            assert torch.equal(g, w), f"{name}[{i}]"
    assert got.step == want.step
    assert torch.equal(got.scaler.scale, want.scaler.scale)
    assert torch.equal(got.scaler.growth_counter, want.scaler.growth_counter)


RESUME_CASES = {
    "bert_lamb_o0": (["--arch", "bert_tiny", "--opt", "lamb", "--lr",
                      "1e-2"], {}),
    "gpt_adam_o2_dynamic_overflow": (
        ["--arch", "gpt_tiny", "--opt", "adam", "--lr", "1e-2",
         "--opt-level", "O2", "--loss-scale", "dynamic"],
        {"overflow_at": 2}),
    "resnet_sgd_eval": (["--arch", "resnet18", "--opt", "sgd", "--lr",
                         "0.05", "--eval", "--eval-batches", "1"], {}),
    "bert_novograd": (["--arch", "bert_tiny", "--opt", "novograd", "--lr",
                       "0.05"], {}),
    "txl_adam_cold_memory": (["--arch", "transformer_xl_tiny", "--opt",
                              "adam", "--lr", "1e-2"], {}),
    "bert_lamb_async": (["--arch", "bert_tiny", "--opt", "lamb", "--lr",
                         "1e-2", "--async-checkpoint"], {}),
    "bert_host_pipeline_accum": (["--arch", "bert_tiny", "--opt", "lamb",
                                  "--lr", "1e-2", "--host-pipeline",
                                  "--grad-accum", "2"], {}),
    "resnet_host_pipeline_accum_remat_eval": (
        ["--arch", "resnet18", "--opt", "sgd", "--lr", "0.05",
         "--host-pipeline", "--grad-accum", "2", "--remat", "block",
         "--eval", "--eval-batches", "1"], {}),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_mid_epoch_is_bitwise(monkeypatch, tmp_path, case):
    argv, drill = RESUME_CASES[case]
    argv = BASE + argv
    if case.startswith("resnet"):
        monkeypatch.setitem(train.IMAGE_ARCHS, "resnet18",
                            functools.partial(resnet18, num_filters=4))
    ck = str(tmp_path / "ck")
    want, out_whole = _run(
        monkeypatch, argv, 4,
        reset_mems_at=3 if case.startswith("txl") else None, **drill)
    first, out_first = _run(monkeypatch, argv + [
        "--checkpoint-dir", ck, "--save-every-steps", "2"], 2, **drill)
    assert "saved checkpoint at step 2" in out_first
    saved = torch.load(os.path.join(ck, "2", "optimizer.pt"),
                       weights_only=True)
    meta = torch.load(os.path.join(ck, "2", "state.pt"), weights_only=True)
    assert meta["step"] == 2
    assert saved["step"] == (1 if "overflow" in case else 2)
    got, out_resumed = _run(monkeypatch, argv + ["--resume", ck], 4,
                            **drill)
    assert "resumed from step 2 (epoch 0)" in out_resumed
    assert "epoch 0 step 3/3" in out_resumed
    assert "epoch 0 step 2/3" not in out_resumed
    _assert_bitwise(got, want)
    assert got.step == 4
    if "overflow" in case:
        assert got.optimizer.step_count == 3
        assert float(got.scaler.scale) == 2.0 ** 15
    if case.startswith("resnet"):
        evals = [[ln for ln in out.splitlines() if " EVAL " in ln]
                 for out in (out_whole, out_resumed)]
        assert evals[0] == evals[1] and len(evals[0]) == 1
        assert len(list(got.model.buffers())) > 0   # BatchNorm statistics


def _bert_state(lr=1e-2):
    model = bert_tiny(device="cpu")
    return create_train_state(model, FusedLAMB(model.parameters(), lr=lr))


def _mlm(i):
    from apex_example_tpu_torch.data.synthetic import mlm_batch
    ids, labels, w = mlm_batch(i, batch_size=4, seq_len=16, vocab_size=256,
                               mask_token_id=255, seed=0)
    return (torch.from_numpy(np.ascontiguousarray(ids)),
            (torch.from_numpy(np.ascontiguousarray(labels)),
             torch.from_numpy(np.ascontiguousarray(w))))


def _values(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.optimizer.state_dict())


def test_restore_copies_in_place_and_keeps_every_pointer(tmp_path):
    state, step = _bert_state(), make_train_step(mlm_loss)
    opt = state.optimizer
    lists = [opt.params, opt.grads, opt.mu, opt.nu]
    tables = [TensorTable(lists)]
    ptrs = [[t.data_ptr() for t in lst] for lst in lists]
    table_ptrs = [list(t._ptrs) for t in tables]
    state, _ = step(state, _mlm(0))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    model_sd, opt_sd = _values(state)
    state, _ = step(state, _mlm(1))
    assert state.step == 2 and opt.step_count == 2
    assert mgr.restore(state) is state
    assert state.step == 1 and opt.step_count == 1
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, model_sd[name]), name
    for name in ("mu", "nu"):
        for got, want in zip(getattr(opt, name), opt_sd[name]):
            assert torch.equal(got, want)
    params = list(state.model.parameters())
    assert all(a is b for a, b in zip(opt.params, params))
    assert [[t.data_ptr() for t in lst] for lst in
            [opt.params, opt.grads, opt.mu, opt.nu]] == ptrs
    for table, before in zip(tables, table_ptrs):
        table.refresh()
        assert table._ptrs == before
    # the step after the restore is the second step again, bit for bit
    state, _ = step(state, _mlm(1))
    again = _bert_state()
    again, _ = step(again, _mlm(0))
    again, _ = step(again, _mlm(1))
    for name, value in again.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[name], value), name


def test_async_save_holds_the_state_of_its_step(tmp_path):
    state, step = _bert_state(), make_train_step(mlm_loss)
    state, _ = step(state, _mlm(0))
    model_sd, opt_sd = _values(state)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, wait=False, host_state={"step": 1})
    state, _ = step(state, _mlm(1))          # overwrites the state in place
    mgr.wait_until_finished()
    assert mgr.latest_step() == 1
    fresh = mgr.restore(_bert_state())
    assert fresh.step == 1 and fresh.optimizer.step_count == 1
    for name, value in fresh.model.state_dict().items():
        assert torch.equal(value, model_sd[name]), name
    for got, want in zip(fresh.optimizer.mu, opt_sd["mu"]):
        assert torch.equal(got, want)
    assert not torch.equal(fresh.optimizer.mu[0], state.optimizer.mu[0])
    mgr.close()


def test_max_to_keep_prunes_steps_and_sidecars_and_missing_raises(tmp_path):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_bert_state())
    with pytest.raises(FileNotFoundError):
        restore_params(directory)
    assert mgr.load_host_state() is None
    state = _bert_state()
    for step in (1, 2, 3, 5):
        state.step = step
        mgr.save(state, host_state={"step": step})
    assert sorted(os.listdir(directory)) == [
        "3", "5", "host_state-3.json", "host_state-5.json"]
    assert mgr.latest_step() == 5
    assert mgr.load_host_state() == {"step": 5}
    with pytest.raises(FileNotFoundError, match="step 2"):
        mgr.restore(state, step=2)


def _jax_trainer_functions(*names):
    """The named functions of the JAX trainer (root train.py), compiled
    from its source alone: importing the module would import orbax (and
    its cloud logging), seconds of a test that needs two stdlib-only
    functions."""
    path = os.path.join(REPO, "train.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    body = [node for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    namespace = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"),
         namespace)
    return types.SimpleNamespace(**{n: namespace[n] for n in names})


def test_sidecar_is_jax_host_loop_state():
    jax_train = _jax_trainer_functions("host_loop_state",
                                       "restore_loop_position")
    args = train.build_parser().parse_args(BASE + ["--seed", "7"])
    for step in (0, 2, 3, 5):
        assert train.host_loop_state(args, step) == \
            jax_train.host_loop_state(args, step)
    mgr = types.SimpleNamespace(load_host_state=lambda step: dict(
        train.host_loop_state(args, step), epoch=9, step_in_epoch=1))
    assert train.restore_loop_position(args, mgr, 5) == \
        jax_train.restore_loop_position(args, mgr, 5) == (9, 1)


def test_serving_takes_the_checkpoint_step_asked_for(monkeypatch, tmp_path):
    ck = str(tmp_path / "ck")
    states, _ = [], None
    build_state = train.build_state

    def keep_state(args, device):
        states.append(build_state(args, device))
        return states[-1]

    kept = {}
    save = CheckpointManager.save

    def keep_params(self, state, **kw):
        save(self, state, **kw)
        kept[state.step] = {k: v.clone()
                            for k, v in state.model.state_dict().items()}

    monkeypatch.setattr(train, "build_state", keep_state)
    monkeypatch.setattr(CheckpointManager, "save", keep_params)
    with contextlib.redirect_stdout(io.StringIO()):
        assert train.main(["--device", "cpu", "--arch", "gpt_tiny", "--opt",
                           "adam", "--lr", "1e-2", "--batch-size", "4",
                           "--seq-len", "16", "--steps-per-epoch", "2",
                           "--checkpoint-dir", ck, "--save-every-steps",
                           "1"]) == 0
    assert sorted(kept) == [1, 2]
    serve = ["--device", "cpu", "--arch", "gpt_tiny", "--requests", "4",
             "--max-len", "32", "--prompt-len", "4:8", "--max-new", "6"]

    def tokens(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            done, _, rc = serve_cli.run_serve(
                serve_cli.build_parser().parse_args(argv))
        assert rc == 0
        return [c.tokens for c in sorted(done, key=lambda c: c.request.uid)
                ], out.getvalue()

    got, header = tokens(serve + ["--checkpoint-dir", ck,
                                  "--checkpoint-step", "1"])
    assert f"params from checkpoint {ck} (step 1)" in header
    latest, header = tokens(serve + ["--checkpoint-dir", ck])
    assert f"params from checkpoint {ck} (step 2)" in header
    untrained, _ = tokens(serve)
    assert got != latest and got != untrained and latest != untrained

    def step1_model(**kw):
        model = gpt_tiny(**kw)
        model.load_state_dict(kept[1])
        return model

    monkeypatch.setattr(serve_cli, "gpt_tiny", step1_model)
    want, _ = tokens(serve)
    assert got == want


def test_load_params_lists_what_does_not_match():
    model = gpt_tiny(device="cpu")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    params.pop("final_ln.scale")
    params["extra.weight"] = torch.zeros(2)
    other = gpt_tiny(device="cpu", vocab_size=128).state_dict()
    params["word_embeddings.weight"] = other["word_embeddings.weight"]
    with pytest.raises(RuntimeError) as exc:
        model.load_state_dict(params)
    msg = str(exc.value)
    assert 'Missing key(s) in state_dict: "final_ln.scale"' in msg
    assert 'Unexpected key(s) in state_dict: "extra.weight"' in msg
    assert ("size mismatch for word_embeddings.weight: copying a param "
            "with shape torch.Size([128, 64]) from checkpoint, the shape "
            "in current model is torch.Size([256, 64])") in msg
    # a match copies in place, cast to the model's dtypes
    half = gpt_tiny(device="cpu", param_dtype=torch.bfloat16)
    before = {k: (v.dtype, v.data_ptr()) for k, v in
              half.state_dict().items()}
    assert torch.bfloat16 in {dt for dt, _ in before.values()}
    half.load_state_dict(model.state_dict())
    for name, value in half.state_dict().items():
        assert (value.dtype, value.data_ptr()) == before[name], name
        assert torch.equal(value, model.state_dict()[name].to(value.dtype))

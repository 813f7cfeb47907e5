"""The trainer's step options beside accumulation in the port held against
the JAX package's, on the CPU at tiny sizes: the ResNet's ``remat`` and
space-to-depth stem, the native host runtime (host_runtime.py) and the
CLI's refusals.  Gradient accumulation is in tests/test_torch_grad_accum.py.

- Remat ``conv`` and ``block`` against ``none`` on BasicBlocks and
  Bottlenecks: grads within 1e-6 (in fact equal), running statistics and
  state_dict keys bitwise equal; the backward recomputes no forward op
  (``none``), BatchNorm but no convolution (``conv``), every convolution
  of the blocks (``block``); an unknown value raises JAX's ValueError.
- The space-to-depth stem: the 7x7 stem's output and JAX's
  SpaceToDepthStem's on the same weights within 1e-5; an odd input takes
  the 7x7 convolution.
- The host runtime: the port's batches bitwise JAX's ``host_runtime`` at
  the same (seed, start_index), the image and both LM forms, and a slice
  of each batch's rows bitwise those rows; each data-parallel process's
  prefetcher makes only its rows; flatten, unflatten, the generator and
  the collate bitwise.
- The CLI's refusals carry the JAX trainer's messages.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_example_tpu import host_runtime as jax_host
from apex_example_tpu.models.resnet import SpaceToDepthStem as JaxS2D
from apex_example_tpu.ops import _config as jax_ops_config
from apex_example_tpu_torch import host_runtime, train
from apex_example_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                                  Conv, ResNet, resnet18)

import train as jax_train

S, V = 16, 256
CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One torch thread; the JAX side on its kernels' XLA forms."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax_ops_config.force_xla(True):
        yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- remat


class _Recomputed(TorchDispatchMode):
    """Counts the forward ops a backward runs: convolutions, and the
    BatchNorms' rsqrt."""

    def __init__(self):
        super().__init__()
        self.counts = {"convolution": 0, "rsqrt": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_remat_recomputes_without_touching_the_statistics(block):
    cls = BasicBlock if block == "basic" else Bottleneck
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, CLASSES, 4))
    runs = {}
    for remat in ("none", "conv", "block"):
        m = ResNet([1, 1], cls, num_classes=CLASSES, num_filters=4,
                   remat=remat, seed=3, device="cpu")
        loss = torch.nn.functional.cross_entropy(m(x), y)
        with _Recomputed() as seen:
            loss.backward()
        out2 = m(x)                       # a second step's statistics
        torch.nn.functional.cross_entropy(out2, y).backward()
        runs[remat] = (seen.counts, m.state_dict(),
                       {n: p.grad for n, p in m.named_parameters()})
    n_conv = sum(isinstance(mod, Conv) for b in m.blocks
                 for mod in b.modules())
    # the backward recomputes: nothing; BatchNorm and ReLU; whole blocks
    assert runs["none"][0] == {"convolution": 0, "rsqrt": 0}
    assert runs["conv"][0]["convolution"] == 0
    assert runs["conv"][0]["rsqrt"] > 0
    assert runs["block"][0] == {"convolution": n_conv,
                                "rsqrt": runs["conv"][0]["rsqrt"]}
    _, sd0, g0 = runs["none"]
    for remat in ("conv", "block"):
        _, sd, grads = runs[remat]
        assert list(sd) == list(sd0)
        for name in sd0:
            if name.endswith((".mean", ".var")):
                assert torch.equal(sd[name], sd0[name]), (remat, name)
        for name, g in g0.items():
            np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{remat} {name}")


# ------------------------------------------------- space-to-depth stem


def test_space_to_depth_stem_equals_the_7x7_stem_and_jax():
    kw = dict(stage_sizes=[1, 1], block_cls=Bottleneck,
              num_classes=CLASSES, num_filters=8, device="cpu", seed=7)
    plain = ResNet(**kw)
    s2d = ResNet(stem_space_to_depth=True, **kw)
    assert list(plain.state_dict()) == list(s2d.state_dict())
    s2d.load_state_dict(plain.state_dict())
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(xt).numpy(), plain(xt).numpy(),
                                   rtol=1e-5, atol=1e-5)
        got = s2d.conv_init(xt).numpy()
    kernel = plain.conv_init.weight.detach().permute(2, 3, 1, 0).numpy()
    want = JaxS2D(8).apply({"params": {"kernel": jnp.asarray(kernel)}},
                           jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- host runtime


@pytest.mark.parametrize("form", ["image", "mlm", "causal"])
def test_prefetchers_give_the_jax_runtimes_batches_bitwise(form):
    if form == "image":
        # 15 x 15 x 3 bytes a row: a share's rows start inside a word of
        # the byte stream
        kw = dict(batch=4, image_size=15, num_classes=10, seed=3,
                  start_index=5)
        mk = (host_runtime.NativePrefetcher, jax_host.NativePrefetcher)
    else:
        mlm = form == "mlm"
        kw = dict(batch=4, seq_len=S, vocab_size=V, mlm=mlm,
                  mask_token_id=V - 1 if mlm else -1, seed=1,
                  start_index=7)
        mk = (host_runtime.NativeLMPrefetcher, jax_host.NativeLMPrefetcher)
    ours, theirs = mk[0](**kw), mk[1](**kw)
    share = mk[0](**kw, rows=slice(1, 3))
    try:
        for _ in range(3):
            got, want, part = next(ours), next(theirs), next(share)
            assert len(got) == len(want) == len(part)
            for g, w, p in zip(got, want, part):
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
                np.testing.assert_array_equal(p.numpy(), w[1:3])
    finally:
        ours.close()
        theirs.close()
        share.close()
    with pytest.raises(StopIteration):
        next(ours)
    with pytest.raises(ValueError):
        mk[0](**kw, rows=slice(2, 2))


@pytest.mark.parametrize("arch", ["resnet18", "bert_tiny"])
def test_each_process_makes_only_its_rows_of_the_global_batch(arch):
    """--host-pipeline under data parallelism: each rank's prefetcher makes
    its own rows, and they are those rows of the one-process batch."""
    from argparse import Namespace
    args = Namespace(arch=arch, dataset="cifar10", batch_size=4, seq_len=S,
                     seed=2, host_pipeline=True)
    vocab = 0 if arch == "resnet18" else V
    whole = train.BatchSource(args, vocab, "cpu", 0, 1, 3)
    ranks = [train.BatchSource(args, vocab, "cpu", r, 2, 3) for r in (0, 1)]
    try:
        want = torch.utils._pytree.tree_leaves(whole.train(3))
        parts = [torch.utils._pytree.tree_leaves(r.train(3)) for r in ranks]
        held = [r.eval(0) for r in ranks]
    finally:
        for src in [whole] + ranks:
            src.close()
    for r, part in enumerate(parts):
        assert ranks[r].prefetcher.rows == 2
        for w, p in zip(want, part):
            assert torch.equal(p, w[2 * r:2 * r + 2])
    assert all(t.shape[0] == 4 for t in
               torch.utils._pytree.tree_leaves(held))


def test_host_runtime_helpers_are_the_jax_runtimes():
    rs = np.random.RandomState(0)
    arrs = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    flat = host_runtime.flatten_f32(arrs)
    np.testing.assert_array_equal(flat, jax_host.flatten_f32(arrs))
    for a, b in zip(host_runtime.unflatten_f32(flat, [(3, 4), (5,)]), arrs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        host_runtime.unflatten_f32(flat, [(2,)])
    np.testing.assert_array_equal(host_runtime.gen_u8(7, 3, 1000),
                                  jax_host.gen_u8(7, 3, 1000))
    frames = rs.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)
    np.testing.assert_array_equal(host_runtime.collate_f32(frames, mean, std),
                                  jax_host.collate_f32(frames, mean, std))
    assert host_runtime.library_path().parent.name == "kernels"


# ------------------------------------------------------------ the CLI


def _message(fn):
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(SystemExit) as exc:
        fn()
    return str(exc.value)


def test_cli_refusals_carry_the_jax_messages(monkeypatch):
    args = ["--batch-size", "6", "--grad-accum", "4"]
    assert _message(lambda: train.main(["--device", "cpu"] + args)) == \
        _message(lambda: jax_train.main(args))
    a = train.build_parser().parse_args(["--batch-size", "8",
                                         "--grad-accum", "8"])
    assert _message(lambda: train.check_parallel_args(a, 2)) == \
        "per-shard batch 4 not divisible by --grad-accum 8"
    monkeypatch.setattr(host_runtime, "available", lambda: False)
    assert _message(lambda: train.main(
        ["--device", "cpu", "--host-pipeline"])) == \
        "--host-pipeline: native runtime not buildable"
    parsed = train.build_parser().parse_args([])
    assert (parsed.grad_accum, parsed.remat, parsed.host_pipeline) == \
        (1, "none", False)
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit):
        train.build_parser().parse_args(["--remat", "all"])
    with pytest.raises(ValueError, match="none|conv|block"):
        resnet18(remat="all", device="cpu")

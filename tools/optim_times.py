#!/usr/bin/env python3
"""Device times and output digests of the port's Adam and LAMB kernels, so
that two checkouts can be compared on one card.

    python3 tools/optim_times.py [--root DIR] [--label NAME]
                                 [--save PATH] [--compare PATH]

``--root`` names the checkout whose ``apex_example_tpu_torch`` is run
(default: this one); its kernels are built from its own sources into its
own ``build/kernels/``.  Run two checkouts in turns in one call (parent,
change, change, parent): each run makes the same inputs on the card from
fixed seeds, runs each kernel once on them, and prints a SHA-256 of every
output buffer, so ``--compare`` (a file another run wrote with ``--save``)
says whether the two checkouts' results are bitwise equal.

The inputs are chip_smoke.py's: Adam (AdamW, step 5, lr 2.5e-4, decay
0.01) over transformer_xl's 241 parameter shapes (150.9 M fp32), its p, m
and v digested; LAMB stage 1 (step 3, the clip at 1.0 reading the grad
norm on the card) and stage 2 (lr 1e-3) over bert_base's 201 shapes
(109.5 M fp32), m, v, u, the per-tensor sums, the ratios and p digested.
A checkout whose wrappers take the step's scalars as a row on the card
(``scalars_t``) runs them with a clear noop flag, as its trainer does;
an older one takes host floats.  Then each kernel's median device time
over 100 launches queued behind a spin kernel (CUDA events), and one JSON
line with the digests and times.

Exits 2 where torch sees no CUDA device.
"""

import argparse
import hashlib
import inspect
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (_bert_base_shapes, _device_ms,  # noqa: E402
                        _txl_shapes)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _lists(shapes, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda s, std: torch.randn(s, device=dev,             # noqa
                                     generator=gen) * std
    p = [rnd(s, 0.05) for s in shapes]
    g = [rnd(s, 1e-3) for s in shapes]
    m = [rnd(s, 1e-3) for s in shapes]
    v = [torch.rand(s, device=dev, generator=gen) * 1e-6 for s in shapes]
    return p, g, m, v


def _kernel_args(fo, fn, lr, c1, c2):
    """The per-step arguments of ``fn`` in this checkout's API: the step's
    row on the card and a clear noop flag, or None for host floats."""
    if "scalars_t" in inspect.signature(fn).parameters:
        return {"scalars_t": fo.step_scalars(lr, c1, c2, "cuda"),
                "noop_flag": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}
    return None


def run(fo, mt):
    out = {"digests": {}, "ms": {}}
    # Adam
    p, g, m, v = _lists(_txl_shapes(), 3)
    table = mt.TensorTable([p, g, m, v])
    step = 5
    c1, c2 = 1.0 / (1 - 0.9 ** step), 1.0 / (1 - 0.999 ** step)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 adam_w_mode=True)
    new = _kernel_args(fo, fo.adam_cuda, 2.5e-4, c1, c2)
    if new is None:
        hyper.update(lr=2.5e-4, bias_c1=c1, bias_c2=c2)
    else:
        hyper.update(new)
    adam = lambda: fo.adam_cuda(table, **hyper)                 # noqa
    adam()
    torch.cuda.synchronize()
    out["digests"]["adam"] = _digest(p + m + v)
    out["ms"]["adam"] = _device_ms(adam, reps=100, warmup=5)

    # LAMB stages 1 and 2
    p, g, m, v = _lists(_bert_base_shapes(), 2)
    table = mt.TensorTable([p, g, m, v])
    u = torch.empty(table.total, dtype=torch.float32, device="cuda")
    c1, c2 = 1.0 / (1 - 0.9 ** 3), 1.0 / (1 - 0.999 ** 3)
    norm, _ = mt.multi_tensor_l2norm_cuda(table, 1)
    h1 = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              max_grad_norm=1.0)
    new = _kernel_args(fo, fo.lamb_stage1_cuda, 1e-3, c1, c2)
    if new is None:
        h1.update(bias_c1=c1, bias_c2=c2)
        stage2 = dict(lr=1e-3)
    else:
        h1.update(new)
        stage2 = new
    sums, ratio = fo.lamb_stage1_cuda(table, u, norm, **h1)
    lamb1 = [t.clone() for t in m + v + [u, sums, ratio]]
    fo.lamb_stage2_cuda(table, u, ratio, **stage2)
    torch.cuda.synchronize()
    out["digests"]["lamb_stage1"] = _digest(lamb1)
    out["digests"]["lamb_stage2"] = _digest(p)
    out["ms"]["lamb_stage1"] = _device_ms(
        lambda: fo.lamb_stage1_cuda(table, u, norm, **h1), reps=100,
        warmup=5)
    out["ms"]["lamb_stage2"] = _device_ms(
        lambda: fo.lamb_stage2_cuda(table, u, ratio, **stage2), reps=100,
        warmup=5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="change")
    ap.add_argument("--save", default="")
    ap.add_argument("--compare", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("optim_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    for name in [m for m in sys.modules
                 if m.startswith("apex_example_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_example_tpu_torch.ops import fused_optim as fo
    from apex_example_tpu_torch.ops import multi_tensor as mt
    result = dict(run(fo, mt), label=args.label, root=args.root,
                  device=torch.cuda.get_device_name(0))
    for name, ms in result["ms"].items():
        print(f"optim_times: {args.label}: {name} {ms:.5f} ms  digest "
              f"{result['digests'][name]}")
    if args.compare:
        other = json.loads(Path(args.compare).read_text())
        same = {k: other["digests"][k] == d
                for k, d in result["digests"].items()}
        result["bitwise_equal_to"] = {"label": other["label"], **same}
        print(f"optim_times: {args.label} against {other['label']}: "
              f"bitwise equal {same}")
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        Path(args.save).write_text(json.dumps(result))
    print(json.dumps(result))
    if args.compare and not all(result["bitwise_equal_to"].values()):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Checkpoints and resume: port of apex_example_tpu/utils/checkpoint.py
(``CheckpointManager`` :30, ``restore_params`` :143).

The JAX package writes the TrainState pytree with orbax.  The port keeps a
format of its own, one directory per step, named by the step as orbax
names its, holding ``torch.save`` files of CPU tensors:

    DIR/<step>/model.pt       the model's state_dict: the parameters (the
                              master weights) and the buffers (BatchNorm
                              running statistics)
    DIR/<step>/optimizer.pt   the optimizer's state_dict: its step count,
                              read from the card, and its moments
    DIR/<step>/state.pt       TrainState.step and the loss scaler's state
                              (scale, growth counter), which the reference
                              holds across a resume
    DIR/host_state-<step>.json  the host-state sidecar (the loop position)

A step directory is written under a temporary name and renamed into place,
so a reader never sees half of one; the newest ``max_to_keep`` steps and
sidecars are kept.  Files load with ``weights_only=True``.

The port's state updates in place, and each optimizer reads its
parameters, grads and moments through a device table of raw pointers
built once (ops/multi_tensor.py ``TensorTable``).  So :meth:`restore`
copies into the storage that is there: the model through
``load_state_dict`` (which copies), the optimizer through its own
``load_state_dict`` (the moments in place; the step count on the card and
the rows of its per-step scalars), the scaler as a new ``ScalerState``.
No tensor is replaced, and every table stays valid.

``save(wait=False)`` copies the state to pinned host memory, waits on an
event until the copies have landed (the next step overwrites the state in
place) and leaves the file writes to one background thread; a later
``save``, ``wait_until_finished`` or ``close`` joins it first.

Under data parallelism every process calls :meth:`save` and only the
writer, rank 0 by default, writes; an optimizer with ``sharded_state``
(optim/distributed.py, ZeRO) gathers its shards in its ``state_dict``, a
collective that every process enters.  Every process restores the same
files.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch

from apex_example_tpu_torch import amp
from apex_example_tpu_torch.parallel.launch import is_main_process

_HOST_STATE_FMT = "host_state-{step}.json"
_HOST_STATE_GLOB = "host_state-*.json"
_PARTS = ("model", "optimizer", "state")


def latest_step(directory: str) -> Optional[int]:
    """The newest step with a complete checkpoint in ``directory``, or
    None."""
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def checkpoint_steps(directory: str) -> List[int]:
    """The steps with a complete checkpoint in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(directory, name)))


def _step_path(directory: str, step: Optional[int]) -> str:
    """The directory of the checkpoint at ``step`` (default: the latest)
    in ``directory``; FileNotFoundError where there is none."""
    step = latest_step(directory) if step is None else int(step)
    path = None if step is None else os.path.join(directory, str(step))
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError(
            f"no checkpoint{'' if step is None else f' at step {step}'} in "
            f"{directory}")
    return path


def _load(step_dir: str, part: str):
    return torch.load(os.path.join(step_dir, f"{part}.pt"),
                      map_location="cpu", weights_only=True)


class CheckpointManager:
    """``save(state)``, ``restore(state)`` in place, ``latest_step()``,
    and the host-state sidecar, over ``directory`` (created on the first
    save)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.writer = is_main_process()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------- save

    def save(self, state, step: Optional[int] = None, wait: bool = True,
             host_state: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint ``state`` (an engine.TrainState) at ``step`` (default
        ``state.step``).  ``wait=False`` returns once the state is copied
        to host memory and writes the files on a background thread.
        ``host_state`` (a JSON-serialisable dict) is written at once as the
        step's sidecar."""
        self.wait_until_finished()
        if not self.writer:
            if getattr(state.optimizer, "sharded_state", False):
                state.optimizer.state_dict()     # the writer's gather
            return
        step = int(state.step) if step is None else int(step)
        trees = {"model": state.model.state_dict(),
                 "optimizer": state.optimizer.state_dict(),
                 "state": {"step": int(state.step),
                           "scaler": amp.state_dict(state.scaler)}}
        snap = self._snapshot(trees, pinned=not wait)
        if host_state is not None:
            self.save_host_state(step, host_state)
        if wait:
            self._write(step, snap)
            return
        self._thread = threading.Thread(target=self._write_async,
                                        args=(step, snap), daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def _snapshot(self, trees, pinned: bool):
        """``trees`` with every tensor copied to host memory (pinned and
        reused from save to save for an asynchronous save from the card),
        once the copies have landed."""
        waits = []

        def host(t: torch.Tensor, key: str) -> torch.Tensor:
            t = t.detach()
            if t.device.type == "cpu":
                return t.clone()
            if not pinned:
                return t.cpu()
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            waits.append(t.device)
            return buf

        def walk(x, key):
            if torch.is_tensor(x):
                return host(x, key)
            if isinstance(x, dict):
                return {k: walk(v, f"{key}/{k}") for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v, f"{key}/{i}") for i, v in enumerate(x))
            return x

        snap = walk(trees, "")
        for device in set(waits):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
        return snap

    def _write(self, step: int, snap) -> None:
        os.makedirs(self.directory, exist_ok=True)
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for part in _PARTS:
            torch.save(snap[part], os.path.join(tmp, f"{part}.pt"))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in checkpoint_steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write_async(self, step: int, snap) -> None:
        try:
            self._write(step, snap)
        except BaseException as exc:     # raised again by the next join
            self._error = exc

    def wait_until_finished(self) -> None:
        """Join a pending asynchronous write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait_until_finished()

    # ---------------------------------------------------------- restore

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, state, step: Optional[int] = None):
        """Copy the checkpoint at ``step`` (default: the latest) into
        ``state`` in place, and return it: the parameters and buffers, the
        optimizer's moments and step count, the scaler and
        ``state.step``."""
        path = _step_path(self.directory, step)
        meta = _load(path, "state")
        state.model.load_state_dict(_load(path, "model"))
        state.optimizer.load_state_dict(_load(path, "optimizer"))
        state.scaler = amp.load_state_dict(state.scaler, meta["scaler"])
        state.step = int(meta["step"])
        return state

    # -------------------------------------------------- host-state sidecar

    def _host_state_path(self, step: int) -> str:
        return os.path.join(self.directory, _HOST_STATE_FMT.format(step=step))

    def save_host_state(self, step: int, host_state: Dict[str, Any]) -> None:
        """Write the sidecar atomically (a temporary file renamed into
        place), pruned to the manager's window."""
        os.makedirs(self.directory, exist_ok=True)
        path = self._host_state_path(int(step))
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(host_state, fh)
        os.replace(tmp, path)
        for old in sorted(self.host_state_steps())[:-self.max_to_keep]:
            try:
                os.remove(self._host_state_path(old))
            except OSError:
                pass

    def host_state_steps(self) -> List[int]:
        steps = []
        for path in glob.glob(os.path.join(self.directory,
                                           _HOST_STATE_GLOB)):
            stem = os.path.basename(path)[len("host_state-"):-len(".json")]
            if stem.isdigit():
                steps.append(int(stem))
        return steps

    def load_host_state(self, step: Optional[int] = None
                        ) -> Optional[Dict[str, Any]]:
        """The sidecar of ``step`` (default: the latest checkpoint's), or
        None where there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._host_state_path(int(step))
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None


def restore_params(directory: str, step: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """The model's state_dict (CPU tensors) of the checkpoint at ``step``
    (default: the latest) in ``directory``, with no template: the serving
    path's restore, for the model's ``load_state_dict``, which copies in
    place, casts to the model's dtypes and lists the names and shapes that
    do not match."""
    return _load(_step_path(os.path.abspath(directory), step), "model")

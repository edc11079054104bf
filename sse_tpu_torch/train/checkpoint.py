"""Checkpoints of the TrainState (port of ``sse_tpu/train/checkpoint.py``,
which uses Orbax): params, Adam state, lr, step and the EMA params, plus
host-side ``extra`` and the ``metrics`` that best-checkpoint retention
ranks by.

Layout: one directory per step under the manager's directory, named by
the step as Orbax names them::

    ckpt/<step>/state.pt       torch.save of the state's tensors (on the CPU)
    ckpt/<step>/extra.json
    ckpt/<step>/metrics.json   null when the save passed no metrics

A save writes a temporary directory and then renames it into place
(``os.replace``), so a process killed during a save leaves the previous
step restorable and the partial one invisible; the next manager on the
directory removes what it left. Saves are synchronous: ``wait`` and
``close`` exist for the JAX class's surface.

Retention is the Orbax manager's, as the JAX package configures it:
``max_to_keep`` most recent steps; with ``best_metric``, the
``max_to_keep`` steps with the highest ``metrics[best_metric]`` (a save
whose metrics lack it ranks as -inf; ties keep the later step; a save
without metrics is never removed). A save at a step at or below the
latest is skipped and returns False, as Orbax's is.

The format is the port's own: an Orbax checkpoint of the JAX package is
carried across by restoring it with ``sse_tpu`` and converting the state
(``sse_tpu_torch.convert.train_state_from_jax``), never read here.

A state on a grid (``TrainState.mesh``) is saved whole: every leaf is
assembled (the row-sharded target table's blocks in row order) before it
is written, so a checkpoint saved on any grid restores on one device and
on any other grid, equal bit for bit. Restoring into a state on a grid
places the restored state on that grid. In a process group of several
ranks every rank calls ``save``: rank 0 writes and removes, and the
others wait for it at a barrier.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import gather
from sse_tpu_torch.train.loop import (
    ScaleByAdamState,
    TrainState,
    adam_count,
    tree_leaves,
    tree_map,
)

_TMP = ".tmp-"


def _host(tree: Any) -> Any:
    """The tree whole on the host (a placed tree assembled)."""
    return None if tree is None else tree_map(lambda t: t.detach().cpu(), gather(tree))


def _state_dict(state: TrainState) -> Dict[str, Any]:
    opt = state.opt_state
    return {
        "params": _host(state.params),
        "opt_state": None if opt is None else {
            "count": int(opt.count), "mu": _host(opt.mu), "nu": _host(opt.nu),
        },
        "step": int(state.step),
        "lr": state.lr.detach().cpu(),
        "ema_params": _host(state.ema_params),
    }


def _structure(tree: Any) -> Any:
    """Nesting, keys and leaf shapes and dtypes of a tree (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype))


def _like(saved: Any, abstract: Any, name: str) -> Any:
    """``saved`` on the devices of ``abstract``'s leaves; raises if the
    two trees differ in structure, shape or dtype."""
    if _structure(saved) != _structure(abstract):
        raise ValueError(f"checkpoint {name} does not match the state to restore into")
    if abstract is None:
        return None
    return tree_map(lambda s, a: s.to(a.device), saved, abstract)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        best_metric: Optional[str] = None,
    ):
        """``best_metric`` (e.g. "recall@1"): keep the max_to_keep BEST
        checkpoints by that metric (passed via save(..., metrics=...))
        instead of the most recent."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        os.makedirs(self.directory, exist_ok=True)
        if distributed.rank() != 0:
            return
        for name in os.listdir(self.directory):  # saves a killed process left
            if name.startswith(_TMP):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # ----------------------------------------------------------- layout
    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def _metrics(self, step: int) -> Optional[dict]:
        with open(self._path(step, "metrics.json"), "r", encoding="utf-8") as f:
            return json.load(f)

    def _score(self, metrics: dict) -> float:
        return metrics.get(self.best_metric, -float("inf"))

    def _ranked(self) -> List[int]:
        """Steps with metrics, worst first (stable: ties keep step order)."""
        with_metrics = [(s, m) for s in self.all_steps() if (m := self._metrics(s)) is not None]
        return [s for s, m in sorted(with_metrics, key=lambda sm: self._score(sm[1]))]

    # ------------------------------------------------------------ save
    def save(
        self,
        state: TrainState,
        step: int,
        extra: Optional[dict] = None,
        metrics: Optional[dict] = None,
    ) -> bool:
        """Commit ``state`` as ``step`` (atomically), then drop the steps
        retention no longer keeps. Returns False, saving nothing, when
        ``step`` is not above the latest step."""
        step = int(step)
        latest = self.latest_step()
        if distributed.world_size() > 1:
            distributed.barrier()  # every rank has read the latest step
            saved = self._save(state, step, latest, extra, metrics) if distributed.rank() == 0 \
                else latest is None or step > latest
            distributed.barrier()  # rank 0 has written
            return saved
        return self._save(state, step, latest, extra, metrics)

    def _save(self, state, step, latest, extra, metrics) -> bool:
        if latest is not None and step <= latest:
            return False
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_state_dict(state), os.path.join(tmp, "state.pt"))
        for name, obj in (("extra.json", extra or {}), ("metrics.json", metrics)):
            with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
                json.dump(obj, f)
        os.replace(tmp, self._path(step))
        for old in self._to_remove():
            shutil.rmtree(self._path(old), ignore_errors=True)
        return True

    def _to_remove(self) -> List[int]:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return []
        if self.best_metric is None:
            return steps[: len(steps) - self.max_to_keep]
        return self._ranked()[: -self.max_to_keep or None]

    # ----------------------------------------------------------- query
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self.best_metric is None:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    # --------------------------------------------------------- restore
    def restore(
        self, abstract_state: TrainState, step: Optional[int] = None
    ) -> Optional[TrainState]:
        """Restore latest (or ``step``) into the structure of
        ``abstract_state``, onto its devices; None if no checkpoint exists.
        Raises ValueError when the checkpoint's trees (params, Adam state,
        EMA params) differ from ``abstract_state``'s. An ``abstract_state``
        on a grid gets the restored state placed on its grid."""
        if abstract_state.mesh is not None:
            from sse_tpu_torch.train.grid import gather_state, place_state

            mesh = abstract_state.mesh
            whole = gather_state(abstract_state)
            restored = self.restore(whole, step)
            return None if restored is None else place_state(restored, mesh)
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step, "state.pt")
        if not os.path.exists(path):
            raise ValueError(
                f"{self._path(step)} holds no state.pt: not a checkpoint of "
                "sse_tpu_torch (an Orbax checkpoint of sse_tpu is carried across "
                "with sse_tpu_torch.convert.train_state_from_jax)"
            )
        saved = torch.load(path, map_location="cpu", weights_only=True)
        params = _like(saved["params"], abstract_state.params, "params")
        opt = abstract_state.opt_state
        if (opt is None) != (saved["opt_state"] is None):
            raise ValueError("checkpoint optimizer state does not match the state to restore into")
        device = tree_leaves(abstract_state.params)[0].device
        if opt is not None:
            s = saved["opt_state"]
            opt = ScaleByAdamState(
                count=adam_count(s["count"], device), mu=_like(s["mu"], opt.mu, "Adam mu"),
                nu=_like(s["nu"], opt.nu, "Adam nu"),
            )
        return TrainState(
            params=params,
            opt_state=opt,
            step=saved["step"],
            lr=saved["lr"].to(device),
            ema_params=_like(saved["ema_params"], abstract_state.ema_params, "ema_params"),
        )

    def restore_extra(self, step: Optional[int] = None) -> Optional[dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with open(self._path(step, "extra.json"), "r", encoding="utf-8") as f:
            return json.load(f)

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        """Holds no resources."""

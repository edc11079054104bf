"""Model-dir workspace: the glue between CLI commands (port of
``sse_tpu/workspace.py``).

A self-describing directory, the same files as the JAX package's but for
the checkpoints: ``config.json`` and ``vocab.txt`` (either package reads
the other's), ``targets.npz`` (the encoded target space), ``ckpt/`` (the
port's checkpoints, ``sse_tpu_torch.train.checkpoint``), ``metrics.jsonl``
and ``index/`` (npy-v1, either package reads the other's). So ``index``,
``eval`` and ``serve`` need only the model dir.

Everything runs on ``device``: one CUDA card, or the CPU where the caller
asks for it. Where the process sees more than one card (or runs in a
process group of several ranks, ``parallel.distributed``), ``mesh()`` is
the ('data', 'model') grid of ``mesh_data`` x ``mesh_model`` cards and
training, the index, eval through the index and serving run on it, as
in the JAX package. In a process group every rank trains its slice of
the global batch on the grid of every rank's device (on the CPU too);
rank 0 alone writes the metrics and the checkpoints. ``build_index``
with ``cp_shards`` encodes the targets context-parallel over that many
devices beside this process's (``parallel.context``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import torch

from sse_tpu_torch.configs import TaskConfig
from sse_tpu_torch.data.corpus import (
    EncodedPairs,
    TargetSpace,
    build_vocab,
    build_vocab_streaming,
    encode_pairs,
    encode_pairs_streaming,
    encode_target_space,
    read_pairs_tsv,
    read_targets_tsv,
)
from sse_tpu_torch.evals import Evaluator
from sse_tpu_torch.index import ShardedIndex, build_index
from sse_tpu_torch.models.sse import SSEConfig
from sse_tpu_torch.parallel import distributed, make_mesh
from sse_tpu_torch.serve import QueryEngine
from sse_tpu_torch.text.subword import SubwordVocab, load_vocab
from sse_tpu_torch.train import TrainState, inference_params, init_train_state
from sse_tpu_torch.train import train as train_loop
from sse_tpu_torch.train.checkpoint import CheckpointManager
from sse_tpu_torch.train.loop import tree_map
from sse_tpu_torch.train.metrics import MetricWriter

_INDEX_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


class Workspace:
    def __init__(self, model_dir: str, cfg: TaskConfig, device: torch.device | str = "cuda"):
        self.model_dir = os.path.abspath(model_dir)
        self.cfg = cfg
        self.device = torch.device(device)

    # ------------------------------------------------------------- layout
    @property
    def config_path(self) -> str:
        return os.path.join(self.model_dir, "config.json")

    @property
    def vocab_path(self) -> str:
        return os.path.join(self.model_dir, "vocab.txt")

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.model_dir, "ckpt")

    @property
    def index_dir(self) -> str:
        return os.path.join(self.model_dir, "index")

    @property
    def metrics_path(self) -> str:
        return os.path.join(self.model_dir, "metrics.jsonl")

    # ------------------------------------------------------------ open/new
    @classmethod
    def create(
        cls, model_dir: str, cfg: TaskConfig, device: torch.device | str = "cuda"
    ) -> "Workspace":
        ws = cls(model_dir, cfg, device)
        os.makedirs(model_dir, exist_ok=True)
        cfg.save(ws.config_path)
        return ws

    @classmethod
    def open(cls, model_dir: str, device: torch.device | str = "cuda") -> "Workspace":
        return cls(model_dir, TaskConfig.load(os.path.join(model_dir, "config.json")), device)

    # ---------------------------------------------------------------- data
    def prepare_data(
        self, data_dir: str, need_eval: bool = True
    ) -> Tuple[SubwordVocab, TargetSpace, Optional[EncodedPairs], Optional[EncodedPairs]]:
        """Vocab build/load, the target-space encode and the pair encode,
        cached in model_dir (``streaming``: TrainPairs never held in RAM,
        encoded into memmaps)."""
        cfg = self.cfg
        train_path = os.path.join(data_dir, "TrainPairs")
        eval_path = os.path.join(data_dir, "EvalPairs")
        target_rows = read_targets_tsv(os.path.join(data_dir, "targetIDs"))
        has_train = os.path.exists(train_path)
        vocab_kw = dict(max_subtoken_length=cfg.max_subtoken_length, vocab_mode=cfg.vocab_mode)
        if cfg.streaming:
            train_rows = []
            vocab = build_vocab_streaming(
                cfg.vocab_size, train_path if has_train else None, target_rows,
                self.vocab_path, **vocab_kw,
            )
        else:
            train_rows = read_pairs_tsv(train_path) if has_train else []
            vocab = build_vocab(cfg.vocab_size, train_rows, target_rows, self.vocab_path, **vocab_kw)
        tspace = encode_target_space(
            vocab, target_rows, cfg.max_seq_length, os.path.join(self.model_dir, "targets.npz")
        )
        if cfg.streaming and has_train:
            train_pairs = encode_pairs_streaming(
                vocab, train_path, tspace, cfg.max_seq_length, cache_dir=self.model_dir
            )
        else:
            train_pairs = (
                encode_pairs(vocab, train_rows, tspace, cfg.max_seq_length) if train_rows else None
            )
        eval_pairs = None
        if need_eval and os.path.exists(eval_path):
            eval_pairs = encode_pairs(vocab, read_pairs_tsv(eval_path), tspace, cfg.max_seq_length)
        return vocab, tspace, train_pairs, eval_pairs

    # --------------------------------------------------------------- model
    def mesh(self):
        """The serving grid: None on one card (and on the CPU), else
        ``make_mesh(mesh_data, mesh_model)`` over the cards of every
        process (JAX: more than one device in ``jax.devices()``)."""
        if self.device.type != "cuda" or distributed.process_info()["global_devices"] <= 1:
            return None
        return make_mesh(self.cfg.mesh_data, self.cfg.mesh_model)

    def train_mesh(self):
        """The training grid: ``mesh()``, or in a process group on the CPU
        the grid of every rank's CPU (JAX's mesh over the processes'
        devices)."""
        if distributed.world_size() > 1 and self.device.type != "cuda":
            return make_mesh(self.cfg.mesh_data, self.cfg.mesh_model, devices=[self.device])
        return self.mesh()

    def model_config(self, vocab: SubwordVocab, tspace: TargetSpace) -> SSEConfig:
        return self.cfg.model_config(vocab.vocab_size, tspace.num_targets)

    def restore_state(
        self, model_cfg: SSEConfig, quiet: bool = False
    ) -> Tuple[TrainState, CheckpointManager]:
        """Fresh state from the config's seed, then the latest checkpoint
        if there is one. A checkpoint whose EMA structure differs from the
        config's is restored all the same: with averaging turned on after
        it was written, the average starts from the restored params; with
        averaging turned off, its averaged params are dropped."""
        state = init_train_state(model_cfg, self.cfg.train_config(), device=self.device)
        mgr = CheckpointManager(self.ckpt_dir)
        try:
            restored = mgr.restore(state)
        except ValueError:
            if state.ema_params is not None:
                restored = mgr.restore(dataclasses.replace(state, ema_params=None))
                if restored is not None:
                    restored = dataclasses.replace(
                        restored, ema_params=tree_map(torch.clone, restored.params)
                    )
            else:
                restored = mgr.restore(
                    dataclasses.replace(state, ema_params=tree_map(torch.clone, state.params))
                )
                if restored is not None:
                    restored = dataclasses.replace(restored, ema_params=None)
        if restored is not None:
            state = restored
            if not quiet:
                print(f"[sse] restored checkpoint step={mgr.latest_step()}")
        return state, mgr

    # ---------------------------------------------------------------- ops
    def train(self, data_dir: str) -> Dict[str, float]:
        """Train (resuming from the latest checkpoint), checkpoint every
        ``steps_per_checkpoint`` steps and at the end, keeping the best
        ``recall@1`` checkpoints when there are EvalPairs. Returns the
        final eval. Trains on ``train_mesh()`` where there is one (the
        restored state is placed on it), else on ``device``. In a process
        group every rank must be given the same model dir (checked); rank
        0 prepares the data first, every rank computes eval, and rank 0
        alone writes the metrics and the checkpoints."""
        multi = distributed.world_size() > 1
        if multi:
            dirs = distributed.all_gather_object(self.model_dir)
            if len(set(dirs)) > 1:
                raise ValueError("model_dir must be the SAME (shared) path on every process: "
                                 f"checkpointing is a cross-process collective, got {dirs}")
            if distributed.rank() != 0:
                distributed.barrier()  # rank 0 writes the vocab and the target cache
        vocab, tspace, train_pairs, eval_pairs = self.prepare_data(data_dir)
        if multi and distributed.rank() == 0:
            distributed.barrier()
        if train_pairs is None:
            raise FileNotFoundError(f"no TrainPairs under {data_dir}")
        model_cfg = self.model_config(vocab, tspace)
        state, mgr = self.restore_state(model_cfg)
        evaluator = (
            Evaluator(model_cfg, eval_pairs, tspace,
                      sample_targets=self.cfg.eval_sample_targets or None)
            if eval_pairs
            else None
        )
        if evaluator is not None:  # retain the best-recall checkpoints
            mgr.close()
            mgr = CheckpointManager(self.ckpt_dir, best_metric="recall@1")
        p0 = distributed.rank() == 0
        writer = MetricWriter(self.metrics_path if p0 else os.devnull)
        state = train_loop(
            model_cfg,
            self.cfg.train_config(),
            train_pairs,
            tspace,
            eval_fn=evaluator.evaluate if evaluator else None,
            checkpoint_fn=lambda s, step, rec: mgr.save(
                s, step, metrics={k: v for k, v in rec.items() if isinstance(v, (int, float))}
            ),
            log_fn=writer.write if p0 else None,
            state=state,
            process_index=distributed.rank(),
            process_count=distributed.world_size(),
            mesh=self.train_mesh(),
            device=self.device,
        )
        final = evaluator.evaluate(inference_params(state)) if evaluator else {}
        mgr.save(state, int(state.step), metrics=final or None)
        mgr.wait()
        mgr.close()
        writer.write({"step": int(state.step), "final": 1, **final})
        writer.close()
        return final

    def build_index(
        self,
        data_dir: str,
        export_tsv: Optional[str] = None,
        capacity: Optional[int] = None,
        phase_times: Optional[Dict[str, float]] = None,
        cp_shards: int = 0,
    ) -> ShardedIndex:
        """Build and save the index (``index_dtype`` precision, ``capacity``
        rows reserved for live adds), row-sharded over ``mesh()`` where
        there is one. ``phase_times`` receives the wall seconds of
        prepare_data, restore, encode and save. ``cp_shards`` > 1 encodes
        the targets context-parallel (``build_index``)."""
        t = time.perf_counter
        t0 = t()
        vocab, tspace, _, _ = self.prepare_data(data_dir, need_eval=False)
        t1 = t()
        model_cfg = self.model_config(vocab, tspace)
        state, mgr = self.restore_state(model_cfg)
        mgr.close()
        t2 = t()
        mesh = self.mesh()
        index = build_index(
            inference_params(state), model_cfg, tspace,
            dtype=_INDEX_DTYPES.get(self.cfg.index_dtype, torch.float32), capacity=capacity,
            mesh=mesh, cp_shards=cp_shards,
        )
        for dev in mesh.local_devices if mesh is not None else [index.emb.device]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t3 = t()
        index.save(self.index_dir)
        t4 = t()
        if export_tsv:
            index.export_tsv(export_tsv)
        if phase_times is not None:
            phase_times.update(prepare_data=t1 - t0, restore=t2 - t1, encode=t3 - t2, save=t4 - t3)
        return index

    def evaluate(self, data_dir: str) -> Dict[str, float]:
        vocab, tspace, _, eval_pairs = self.prepare_data(data_dir)
        if eval_pairs is None:
            raise FileNotFoundError(f"no EvalPairs under {data_dir}")
        model_cfg = self.model_config(vocab, tspace)
        state, mgr = self.restore_state(model_cfg)
        mgr.close()
        return Evaluator(model_cfg, eval_pairs, tspace).evaluate(inference_params(state))

    def engine(
        self,
        data_dir: Optional[str] = None,
        k: int = 10,
        max_batch: int = 8,
        bulk_batch: Optional[int] = None,
    ) -> QueryEngine:
        """Everything serving needs: the saved index if there is one (on
        ``mesh()`` where there is one), else one built from ``data_dir``;
        the latest checkpoint's inference params."""
        vocab = load_vocab(self.vocab_path)  # dispatches on the word-mode marker
        if os.path.isdir(self.index_dir):
            index = ShardedIndex.load(self.index_dir, self.mesh() or self.device)
        elif data_dir:
            index = self.build_index(data_dir)
        else:
            raise FileNotFoundError("no built index in model_dir and no --data_dir to build from")
        # source-encoder-only models size their target table by num_targets
        model_cfg = self.cfg.model_config(vocab.vocab_size, index.num_real)
        state, mgr = self.restore_state(model_cfg, quiet=True)
        mgr.close()
        return QueryEngine(
            inference_params(state), model_cfg, vocab, index,
            max_seq_length=self.cfg.max_seq_length, max_batch=max_batch,
            bulk_batch=bulk_batch, k=k,
        )

"""Typed per-task config presets (port of ``sse_tpu/configs``).

The same ``TaskConfig`` (fields and defaults), the same four task
``PRESETS`` and named ``RECIPES``, with ``model_config()`` and
``train_config()`` building the port's ``SSEConfig`` and
``TrainConfig``, and the same ``config.json`` format (``to_json``,
``from_json``, ``save``, ``load``): a file written by either package
loads in the other. This loader imports no JAX (the JAX one imports the
JAX models). Every preset and recipe runs in the port: the GRU presets,
qna's LSTM with the attention readout, the ``compositional`` recipe's
residual LSTM stack and the ``transformer`` recipe's pre-LN blocks. See
``sse_tpu/configs/__init__.py`` for where each preset's numbers were
measured (TPU runs of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json

from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.models.towers import TowerConfig
from sse_tpu_torch.train.losses import LossConfig
from sse_tpu_torch.train.loop import TrainConfig


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Mirror of ``sse_tpu.configs.TaskConfig``: same fields, same
    defaults (see that class for what each one means)."""

    task_type: str = "classification"
    network_mode: str = "source-encoder-only"
    vocab_size: int = 8000
    vocab_mode: str = "subword"
    max_seq_length: int = 50
    max_subtoken_length: int = 20
    embed_dim: int = 128
    hidden: int = 128
    tgt_hidden: int = 0
    num_layers: int = 1
    encoding_dim: int = 128
    cell: str = "gru"
    readout: str = "final"
    residual: bool = False
    pos_encoding: str = "rope"
    embed_grad: str = "take"
    batch_size: int = 128
    learning_rate: float = 0.01
    learning_rate_decay_factor: float = 0.9
    max_gradient_norm: float = 5.0
    optimizer: str = "adam"
    loss_kind: str = "full"
    loss_scale: float = 20.0
    num_negatives: int = 128
    margin: float = 0.0
    bidirectional: bool = False
    num_hard_negatives: int = 0
    hard_negative_refresh: int = 500
    dropout: float = 0.0
    ema_decay: float = 0.0
    steps_per_checkpoint: int = 200
    steps_per_dispatch: int = 8
    max_epochs: int = 20
    seed: int = 0
    eval_sample_targets: int = 0
    index_dtype: str = "float32"
    streaming: bool = False
    shuffle_window: int = 262144
    mesh_data: int = -1
    mesh_model: int = 1

    def model_config(self, vocab_size: int, num_targets: int) -> SSEConfig:
        """Concrete SSEConfig once the real vocab/target sizes are known."""
        src = TowerConfig(
            vocab_size=vocab_size,
            embed_dim=self.embed_dim,
            hidden=self.hidden,
            num_layers=self.num_layers,
            encoding_dim=self.encoding_dim,
            cell=self.cell,
            readout=self.readout,
            max_len=max(self.max_seq_length, 512),
            dropout=self.dropout,
            residual=self.residual,
            pos_encoding=self.pos_encoding,
            embed_grad=self.embed_grad,
        )
        mode = NetworkMode(self.network_mode)
        if mode == NetworkMode.SOURCE_ENCODER_ONLY:
            return SSEConfig(mode=mode, src_tower=src, num_targets=num_targets)
        if mode == NetworkMode.SHARED_ENCODER:
            return SSEConfig(mode=mode, src_tower=src)
        tgt = dataclasses.replace(src, hidden=self.tgt_hidden or self.hidden)
        return SSEConfig(mode=mode, src_tower=src, tgt_tower=tgt)

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            learning_rate_decay_factor=self.learning_rate_decay_factor,
            max_gradient_norm=self.max_gradient_norm,
            optimizer=self.optimizer,
            loss=LossConfig(
                kind=self.loss_kind,
                scale=self.loss_scale,
                num_negatives=self.num_negatives,
                margin=self.margin,
                bidirectional=self.bidirectional,
                num_hard_negatives=self.num_hard_negatives,
            ),
            steps_per_checkpoint=self.steps_per_checkpoint,
            steps_per_dispatch=self.steps_per_dispatch,
            max_epochs=self.max_epochs,
            seed=self.seed,
            hard_negative_refresh=self.hard_negative_refresh,
            shuffle_window=self.shuffle_window if self.streaming else 0,
            ema_decay=self.ema_decay,
        )

    # -------------------------------------------------------------- persist
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TaskConfig":
        """Unknown keys are dropped, missing ones take their defaults."""
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TaskConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())


CLASSIFICATION = TaskConfig(
    task_type="classification",
    network_mode="source-encoder-only",
    loss_kind="full",
    max_epochs=40,
    dropout=0.1,
    ema_decay=0.999,
)
RANKING = TaskConfig(
    task_type="ranking",
    network_mode="dual-encoder",
    loss_kind="sampled",
    num_negatives=128,
    num_hard_negatives=16,
    ema_decay=0.999,
)
CROSSLINGUAL = TaskConfig(
    task_type="crosslingual",
    network_mode="dual-encoder",
    loss_kind="sampled",
    num_negatives=128,
    num_hard_negatives=16,
    max_epochs=60,
    dropout=0.1,
    ema_decay=0.999,
)
QNA = TaskConfig(
    task_type="qna",
    network_mode="dual-encoder",
    cell="lstm",
    readout="attention",
    loss_kind="sampled",
    num_negatives=128,
    num_hard_negatives=16,
    learning_rate=0.003,
    ema_decay=0.999,
)

PRESETS = {
    "classification": CLASSIFICATION,
    "ranking": RANKING,
    "crosslingual": CROSSLINGUAL,
    "qna": QNA,
}

# named recipes applied on top of a task preset (explicit flags still win)
RECIPES = {
    "compositional": {
        "cell": "lstm",
        "num_layers": 3,
        "residual": True,
        "learning_rate": 0.003,
        "dropout": 0.1,
        "max_epochs": 40,
    },
    "transformer": {
        "cell": "transformer",
        "num_layers": 4,
        "pos_encoding": "rope",
        "learning_rate": 0.001,
        "dropout": 0.0,
        "max_epochs": 40,
    },
}


def preset(task_type: str, recipe: "str | None" = None, **overrides) -> TaskConfig:
    """Task preset + optional named recipe bundle + explicit overrides
    (later wins)."""
    base = PRESETS[task_type]
    merged = dict(RECIPES[recipe]) if recipe else {}
    merged.update(overrides)
    return dataclasses.replace(base, **merged) if merged else base

"""Framework configuration — the typed flag layer the reference lacks.

The reference hardcodes every knob: the monitor launch command
(traffic_classifier.py:22), the 15-minute collection timeout (:27), model
pickle paths (:230-240), the 1 Hz poll period (simple_monitor_13.py:36),
and the print-every-10-lines cadence (traffic_classifier.py:167); SURVEY.md
§5 calls for a real config layer for mesh shape, batch/padding policy,
model choice, and poll rates. One frozen dataclass, JSON round-trip,
overridable field-by-field from CLI flags or environment.

The port's copy of the JAX package's ``config.py`` (same schema, so one
file configures both CLIs). The port's CLI reads ``ingest.capacity``,
``ingest.idle_timeout_s``, ``ingest.monitor_cmd``, ``print_every`` and
``model.native_checkpoint``; a non-zero ``ingest.shards`` is a usage
error there, since sharding is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape (parallel/mesh.py axes)."""

    n_data: int = 1  # batch-sharding axis size
    n_state: int = 1  # model-state-sharding axis size (KNN corpus, RF trees)


@dataclass(frozen=True)
class IngestConfig:
    """Host-shell ingest policy (ingest/batcher.py, ingest/collector.py)."""

    capacity: int = 65536  # flow-table rows
    # padded batch sizes (mirror ingest/batcher.DEFAULT_BUCKETS: the top
    # bucket covers a full 2²⁰-record tick in one flush)
    buckets: tuple = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
    shards: int = 0  # >1: mesh-shard the flow table (--shards)
    idle_timeout_s: int = 60  # flow eviction horizon (0 = never)
    poll_period_s: float = 1.0  # monitor poll cadence (reference: 1 Hz)
    monitor_cmd: str | None = None  # None → reference's ryu command
    queue_size: int = 1 << 16


@dataclass(frozen=True)
class ModelConfig:
    """Model family + checkpoint selection."""

    name: str = "forest"  # MODEL_MODULES key
    # resolution: CLI --checkpoint-dir > this field > $TCSDN_MODELS_DIR >
    # ./models (the reference's own relative layout, traffic_classifier.py:230)
    checkpoint_dir: str | None = None
    native_checkpoint: str | None = None  # io/checkpoint.py dir (wins)
    dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Offline retraining knobs (train/*)."""

    test_size: float = 0.5  # notebook 50/50 split
    seed: int = 101  # notebook random_state
    collect_duration_s: float = 15 * 60  # reference TIMEOUT (:27)
    checkpoint_every: int = 0  # steps between train-state saves (0 = off)
    train_state_dir: str | None = None  # where resumable state lands


@dataclass(frozen=True)
class Config:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    print_every: int = 10  # render cadence, poll ticks


def _to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)

    def tuples_to_lists(v):
        if isinstance(v, dict):
            return {k: tuples_to_lists(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return list(v)
        return v

    return tuples_to_lists(d)


def save(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=1)


def load(path: str) -> Config:
    with open(path) as f:
        return from_dict(json.load(f))


def from_dict(d: dict) -> Config:
    """Build a Config from a (possibly partial) nested dict — unknown keys
    are an error, missing keys take defaults."""

    def build(cls, sub: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(sub) - names
        if unknown:
            raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in sub:
                continue
            v = sub[f.name]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    return Config(
        mesh=build(MeshConfig, d.get("mesh", {})),
        ingest=build(IngestConfig, d.get("ingest", {})),
        model=build(ModelConfig, d.get("model", {})),
        train=build(TrainConfig, d.get("train", {})),
        **{k: v for k, v in d.items()
           if k not in ("mesh", "ingest", "model", "train")},
    )

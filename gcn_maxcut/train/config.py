"""Training configuration (reference ``TrainingConfig`` parity + extensions).

Field-for-field superset of the reference dataclass
(``Training/TrainingNeural.py:36-67``), with the same defaulting rules:
``dim_embedding`` defaults to ``n_nodes``; ``hidden_dim`` to
``dim_embedding // 2``.  Frozen (hashable) so it can be a static jit arg.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    # Model parameters
    n_nodes: int = 1000
    dim_embedding: Optional[int] = None    # defaults to n_nodes
    hidden_dim: Optional[int] = None       # defaults to dim_embedding // 2
    dropout: float = 0.0
    number_classes: int = 3

    # Training parameters
    learning_rate: float = 0.001
    number_epochs: int = 1000
    tolerance: float = 1e-4
    patience: int = 20
    prob_threshold: float = 0.5

    # Loss parameters
    A: float = 0.0
    C: float = 1.0
    penalty: float = 1000.0                # only applied if use_penalty

    # Saving parameters
    save_directory: Optional[str] = None   # model name stem; None = no saving
    save_frequency: int = 100

    # Extensions (no reference analog)
    feature_mode: str = "adjacency"        # "adjacency" | "embedding"
    use_penalty: bool = False              # reference keeps it commented out
    seed: int = 0
    log_every: Optional[int] = None        # defaults to save_frequency
    epochs_per_call: int = 1               # >1 scans epochs inside one jit
                                           # (amortizes host round-trips;
                                           # early-stop granularity = chunk)
    step_mode: str = "per_graph"           # "per_graph" (reference parity:
                                           # one Adam step per graph, epochs
                                           # are sequential scans) |
                                           # "batched" (one
                                           # Adam step per epoch on the
                                           # summed loss over the vmapped
                                           # batch — graphs run in parallel
                                           # as batched GEMMs)
    lr_schedule: str = "constant"          # "constant" | "cosine": cosine
                                           # decays the lr over the full
                                           # number_epochs horizon down to
                                           # lr_final_fraction * lr (a
                                           # training-recipe lever the
                                           # reference lacks; quality suite
                                           # measures its effect)
    lr_final_fraction: float = 0.05
    loss_mode: str = "ste"                 # "ste" (reference parity: STE
                                           # argmax hard-cut loss) |
                                           # "quantile" (train on mean +
                                           # quantile_c * std of the sampled
                                           # decode's cut — the closed-form
                                           # best-of-N objective; see
                                           # objectives.quantile_cut_loss)
    quantile_c: float = 2.6                # ~E[max of 200 std normals]
    entropy_weight: float = 0.0            # > 0 adds -w * Σ_real H(p_i) to
                                           # the loss: keeps the learned
                                           # distribution diverse so the
                                           # 200-rollout sampled decode
                                           # (best-of-N) explores a wider
                                           # neighborhood of the argmax — a
                                           # training-recipe lever aimed at
                                           # the post-vs-randomized gate
                                           # (decode contract untouched)
    aggregation: str = "auto"              # "auto" | "sparse" | "dense":
                                           # dense = neighborhood aggregation
                                           # as an n_pad x n_pad matmul
                                           # (fastest for small padded
                                           # graphs); auto picks dense when
                                           # n_pad <= 2048

    def __post_init__(self):
        if self.dim_embedding is None:
            object.__setattr__(self, "dim_embedding", self.n_nodes)
        if self.hidden_dim is None:
            object.__setattr__(self, "hidden_dim", self.dim_embedding // 2)
        if self.log_every is None:
            object.__setattr__(self, "log_every", self.save_frequency)
        if self.feature_mode not in ("adjacency", "embedding"):
            raise ValueError(f"unknown feature_mode {self.feature_mode!r}")
        if self.aggregation not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.step_mode not in ("per_graph", "batched"):
            raise ValueError(f"unknown step_mode {self.step_mode!r}")
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.loss_mode not in ("ste", "quantile"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        return cls(**json.loads(s))

"""Dataset (de)serialization and the text graph format loader.

Replaces the reference's pickle persistence (``commons.py:22-36``
``save_object``/``open_file``; batched dataset spills,
``graphExtender.py:118-122``) with a portable NumPy ``.npz`` layout — no
arbitrary-code-execution pickle, loadable anywhere.  Also implements the
reference's text graph format (``prepareData.ipynb`` cell 2,
``TextGraphLoader``): first line ``[t1, t2, t3]`` terminals, then one
``u v w`` edge per line.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np

from gcn_maxcut.data.generate import GraphSpec
from gcn_maxcut.data.process import DataConfig, ProcessedDataset, process_graphs


def save_object(obj, path: str | Path) -> None:
    """Pickle helper for reference-format interop (``commons.py:22-25``)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_object(path: str | Path):
    """Unpickle helper (``commons.py:26-36``). Trusted inputs only."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_dataset(dataset: ProcessedDataset, path: str | Path) -> None:
    """Serialize specs + config to a single ``.npz`` (graphs rebuilt on load)."""
    path = Path(path)
    arrays = {}
    meta: Dict[str, object] = {
        "config": {
            "max_nodes": dataset.config.max_nodes,
            "num_terminals": dataset.config.num_terminals,
            "node_pad_multiple": dataset.config.node_pad_multiple,
            "edge_pad_multiple": dataset.config.edge_pad_multiple,
        },
        "keys": [],
    }
    for i, spec in dataset.specs.items():
        arrays[f"edges_{i}"] = spec.edges
        if spec.weights is not None:
            arrays[f"weights_{i}"] = spec.weights
        meta["keys"].append(
            {
                "index": int(i),
                "n_nodes": spec.n_nodes,
                "terminals": list(spec.terminals),
                "degree": spec.degree,
                "weighted": spec.weights is not None,
            }
        )
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_dataset(path: str | Path) -> ProcessedDataset:
    """Load and re-tensorize a dataset saved by `save_dataset`."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
        specs: Dict[int, GraphSpec] = {}
        for rec in meta["keys"]:
            i = rec["index"]
            specs[i] = GraphSpec(
                n_nodes=rec["n_nodes"],
                edges=data[f"edges_{i}"],
                terminals=rec["terminals"],
                degree=rec["degree"],
                weights=data[f"weights_{i}"] if rec["weighted"] else None,
            )
    cfg = DataConfig(**meta["config"])
    return process_graphs(specs, cfg)


def load_text_graph(path: str | Path) -> GraphSpec:
    """Parse the reference text format: ``[t1, t2, t3]`` then ``u v w`` lines."""
    lines = Path(path).read_text().strip().splitlines()
    terminals = json.loads(lines[0])
    edges: List[List[int]] = []
    weights: List[float] = []
    for line in lines[1:]:
        parts = line.split()
        if not parts:
            continue
        u, v = int(parts[0]), int(parts[1])
        w = float(parts[2]) if len(parts) > 2 else 1.0
        edges.append([min(u, v), max(u, v)])
        weights.append(w)
    e = np.asarray(edges, dtype=np.int64)
    n = int(e.max()) + 1 if e.size else max(terminals) + 1
    return GraphSpec(
        n_nodes=n,
        edges=e,
        terminals=[int(t) for t in terminals],
        weights=np.asarray(weights, dtype=np.float32),
    )

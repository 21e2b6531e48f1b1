"""Checkpointing: params + optimizer state + history as portable ``.npz``.

Capability parity with the reference's ``torch.save`` dict checkpoints
(``Training/TrainingNeural.py:447-482``: keys ``epoch/model/optimizer/
loss_history/inputs/config``) and its loader ``load_neural_model``
(``:572-609``), including the ``epoch_{e}_loss_{l:.4f}_{name}`` /
``final_{name}`` naming scheme.  Uses flattened-pytree ``.npz`` + JSON
instead of pickle: no arbitrary code execution on load (the reference needed
a 3-stage PyTorch-2.6 ``weights_only`` fallback chain for exactly this
reason, ``:583-597``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import jax
import numpy as np

from gcn_maxcut.train.config import TrainingConfig


def checkpoint_name(
    name: str, epoch: int | None = None, loss: float | None = None
) -> str:
    """Reference naming: ``epoch_{e}_loss_{l:.4f}_{name}`` or ``final_{name}``.

    ``name`` may include a directory; the prefix applies to the basename.
    """
    p = Path(name)
    if epoch is None:
        return str(p.with_name(f"final_{p.name}"))
    return str(p.with_name(f"epoch_{epoch}_loss_{loss:.4f}_{p.name}"))


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def save_checkpoint(
    path: str | Path,
    *,
    params: Any,
    opt_state: Any = None,
    epoch: int = 0,
    loss_history: list[float] | None = None,
    embed: Any = None,
    config: TrainingConfig | None = None,
) -> Path:
    """Write a checkpoint; returns the path (``.npz`` appended if missing)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    arrays: Dict[str, np.ndarray] = {}
    for prefix, tree in (("params", params), ("opt", opt_state), ("embed", embed)):
        if tree is not None:
            for k, v in _flatten_with_paths(tree).items():
                v = np.asarray(v)
                if v.dtype.kind == "V" or v.dtype.name == "bfloat16":
                    # bf16 (ml_dtypes) does not round-trip through npz
                    # (loads back as raw void); store as f32 — lossless
                    # upcast, restored to the template dtype on load
                    v = v.astype(np.float32)
                arrays[f"{prefix}:{k}"] = v
    meta = {
        "epoch": int(epoch),
        "loss_history": [float(x) for x in (loss_history or [])],
        "config": None if config is None else config.to_json(),
        "params_treedef": None,
    }
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_checkpoint(
    path: str | Path,
    params_template: Any,
    opt_state_template: Any = None,
    embed_template: Any = None,
) -> Tuple[Any, Any, Any, Dict[str, Any]]:
    """Load into the structure of the given templates (shape-checked).

    Returns ``(params, opt_state, embed, meta)`` where meta holds
    ``epoch``, ``loss_history``, and the parsed ``config`` (or None).
    """
    path = Path(path)
    if not path.exists() and path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode())

        def restore(prefix, template):
            if template is None:
                return None
            flat = _flatten_with_paths(template)
            leaves = []
            for k, tmpl in flat.items():
                arr = data[f"{prefix}:{k}"]
                if arr.shape != tmpl.shape:
                    raise ValueError(
                        f"checkpoint leaf {prefix}:{k} shape {arr.shape} != "
                        f"template {tmpl.shape}"
                    )
                if arr.dtype != tmpl.dtype:
                    # bf16 leaves were stored as f32 (npz round-trip)
                    arr = arr.astype(tmpl.dtype)
                leaves.append(arr)
            treedef = jax.tree_util.tree_structure(template)
            return jax.tree_util.tree_unflatten(treedef, leaves)

        params = restore("params", params_template)
        opt_state = restore("opt", opt_state_template)
        embed = restore("embed", embed_template)
    if meta.get("config"):
        meta["config"] = TrainingConfig.from_json(meta["config"])
    return params, opt_state, embed, meta

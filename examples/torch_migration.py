"""Migrating a reference PyTorch checkpoint to this framework and back.

A user of the reference (`MJavaadAkhtar/GCN-max-cut`) has `.pth` files
written by ``train_model`` (``Training/TrainingNeural.py:447-482``).  This
script shows the full round trip:

  1. load the reference checkpoint — DGL GraphConv weights map 1:1, the
     torch Adam moments graft into optax state, the pickled config is
     translated (no reference code needs to be installed);
  2. continue training on the accelerator from exactly where the reference stopped;
  3. export back to the reference's torch.save layout so its own tooling
     (``load_neural_model``) can read the result.

Equivalent CLI:
    python -m gcn_maxcut convert final_mymodel.pth migrated.npz
    python -m gcn_maxcut convert final_mymodel.npz exported.pth

Usage:
    python examples/torch_migration.py path/to/final_model.pth
"""

import sys

import jax

from gcn_maxcut.core.graph import pad_graph_batch
from gcn_maxcut.data import DataConfig, generate_graph, process_graphs
from gcn_maxcut.train import (
    TrainingConfig,
    load_torch_checkpoint,
    make_epoch_fn,
    save_torch_checkpoint,
    setup_train_state,
)


def main(path: str) -> int:
    # 1. inspect + translate the checkpoint's own config
    _, _, meta = load_torch_checkpoint(path)
    cfg: TrainingConfig = meta["config"]
    print(f"loaded {path}: epoch {meta['epoch']}, "
          f"{len(meta['loss_history'])} loss records, "
          f"model {cfg.dim_embedding}->{cfg.hidden_dim}->{cfg.number_classes}")

    # 2. graft weights + Adam moments into a live train state and resume
    state = setup_train_state(cfg)
    params, opt_state, meta = load_torch_checkpoint(
        path, optimizer=state.optimizer, params_template=state.params
    )
    if "embed" not in params:
        params["embed"] = state.params["embed"]

    specs = [
        generate_graph(n=min(cfg.n_nodes, 500), d=6, graph_type="reg", seed=i)
        for i in range(4)
    ]
    ds = process_graphs(specs, DataConfig(max_nodes=cfg.n_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    epoch_fn = make_epoch_fn(cfg, state.optimizer)
    params, opt_state, losses = epoch_fn(
        params, opt_state or state.opt_state, batch,
        jax.random.PRNGKey(0), num_epochs=5,
    )
    print("resumed 5 epochs, losses:", [float(x) for x in losses])

    # 3. export back for reference tooling
    out = save_torch_checkpoint(
        path.replace(".pth", "_continued.pth"), params,
        epoch=meta["epoch"] + 5,
        loss_history=meta["loss_history"] + [float(losses[-1])],
        config=cfg, opt_state=opt_state,
    )
    print("exported", out)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__)
        raise SystemExit(1)
    raise SystemExit(main(sys.argv[1]))

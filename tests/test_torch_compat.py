"""Reference .pth checkpoint migration: load, Adam-state graft, round-trip.

Synthesizes a checkpoint byte-identical in *structure* to what the
reference's ``train_model`` writes (``TrainingNeural.py:447-482``): a
``torch.save`` dict with a DGL-layout ``GCNSoftmax`` state_dict, a stepped
torch Adam state, the unused embedding table under ``inputs``, and a
pickled config whose class is NOT importable at load time (module path
``Training.TrainingNeural`` does not exist here — exercising the
permissive unpickler).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.core.graph import pad_graph_batch
from gcn_maxcut.train import (
    TrainingConfig,
    load_torch_checkpoint,
    make_epoch_fn,
    save_torch_checkpoint,
    setup_train_state,
)

N, HID, K = 64, 32, 3


def _ref_config_instance():
    """A config object pickled under a module path importable only while
    saving (registered in sys.modules, removed after) — at load time the
    class cannot be imported, like a real reference checkpoint here."""
    import types

    RefCfg = dataclasses.make_dataclass(
        "TrainingConfig",
        [("n_nodes", int, dataclasses.field(default=N)),
         ("hidden_dim", int, dataclasses.field(default=HID)),
         ("number_classes", int, dataclasses.field(default=K)),
         ("learning_rate", float, dataclasses.field(default=2e-3)),
         ("number_epochs", int, dataclasses.field(default=77)),
         ("patience", int, dataclasses.field(default=11))],
    )
    RefCfg.__module__ = "Training.TrainingNeural"
    pkg = types.ModuleType("Training")
    mod = types.ModuleType("Training.TrainingNeural")
    mod.TrainingConfig = RefCfg
    pkg.TrainingNeural = mod
    sys.modules["Training"] = pkg
    sys.modules["Training.TrainingNeural"] = mod
    return RefCfg()


def _make_reference_checkpoint(path):
    g = torch.Generator().manual_seed(0)
    tensors = [
        torch.randn(N, HID, generator=g),      # conv1.weight (in, out) DGL layout
        torch.zeros(HID),                      # conv1.bias
        torch.randn(HID, K, generator=g),      # conv2.weight
        torch.zeros(K),                        # conv2.bias
        torch.randn(N, N, generator=g),        # embed.weight
    ]
    params = [t.clone().requires_grad_(True) for t in tensors]
    opt = torch.optim.Adam(params, lr=2e-3)
    loss = sum((p ** 2).sum() for p in params[:4])  # embed gets no grad
    loss.backward()
    opt.step()

    state_dict = {
        "conv1.weight": params[0].detach(),
        "conv1.bias": params[1].detach(),
        "conv2.weight": params[2].detach(),
        "conv2.bias": params[3].detach(),
    }
    ckpt = {
        "epoch": 42,
        "model": state_dict,
        "optimizer": opt.state_dict(),
        "loss_history": [-1.0, -5.0, -9.5],
        "inputs": params[4].detach(),
        "config": _ref_config_instance(),
    }
    torch.save(ckpt, path)
    sys.modules.pop("Training.TrainingNeural", None)
    sys.modules.pop("Training", None)
    return ckpt


def test_load_reference_checkpoint(tmp_path):
    path = str(tmp_path / "final_refmodel.pth")
    ref = _make_reference_checkpoint(path)

    params, opt_state, meta = load_torch_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(params["conv1"]["w"]), ref["model"]["conv1.weight"].numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(params["embed"]), ref["inputs"].numpy()
    )
    assert meta["epoch"] == 42
    assert meta["loss_history"] == [-1.0, -5.0, -9.5]
    cfg = meta["config"]
    assert isinstance(cfg, TrainingConfig)
    assert (cfg.n_nodes, cfg.hidden_dim, cfg.learning_rate, cfg.patience) == (
        N, HID, 2e-3, 11,
    )
    assert opt_state is None  # no optimizer template given


def test_adam_state_graft_and_resume(tmp_path):
    path = str(tmp_path / "final_refmodel.pth")
    ref = _make_reference_checkpoint(path)
    cfg = TrainingConfig(n_nodes=N, hidden_dim=HID, learning_rate=2e-3)
    state = setup_train_state(cfg)
    params, opt_state, meta = load_torch_checkpoint(
        path, optimizer=state.optimizer, params_template=state.params
    )
    adam = opt_state.inner_state[0]
    assert int(adam.count) == 1
    t_state = ref["optimizer"]["state"]
    np.testing.assert_allclose(
        np.asarray(adam.mu["conv1"]["w"]), t_state[0]["exp_avg"].numpy(),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(adam.nu["conv2"]["w"]), t_state[2]["exp_avg_sq"].numpy(),
        rtol=1e-6,
    )

    # resume training on a small batch: must run and produce finite loss
    rng = np.random.default_rng(3)
    a = np.triu((rng.random((40, 40)) < 0.3).astype(np.float32), 1)
    gph = graph_from_dense(a + a.T, n_pad=N)
    batch = pad_graph_batch([gph])
    fn = make_epoch_fn(cfg, state.optimizer)
    params2, _, losses = fn(
        params, opt_state, batch, jax.random.PRNGKey(0), num_epochs=2
    )
    assert np.isfinite(np.asarray(losses)).all()


def test_round_trip_export(tmp_path):
    cfg = TrainingConfig(n_nodes=N, hidden_dim=HID)
    state = setup_train_state(cfg)
    out = str(tmp_path / "exported.pth")
    save_torch_checkpoint(
        out, state.params, epoch=7, loss_history=[-3.0], config=cfg,
        opt_state=state.opt_state,
    )
    ckpt = torch.load(out, weights_only=False)
    assert ckpt["epoch"] == 7
    assert ckpt["config"].n_nodes == N
    np.testing.assert_array_equal(
        ckpt["model"]["conv1.weight"].numpy(),
        np.asarray(state.params["conv1"]["w"]),
    )
    # re-import our own export
    params, _, meta = load_torch_checkpoint(out)
    np.testing.assert_array_equal(
        np.asarray(params["conv2"]["w"]), np.asarray(state.params["conv2"]["w"])
    )
    assert meta["config"].n_nodes == N

    # the reference's actual resume path: a live torch Adam must accept the
    # exported optimizer state and step without error
    tparams = [
        torch.zeros(N, HID, requires_grad=True),
        torch.zeros(HID, requires_grad=True),
        torch.zeros(HID, K, requires_grad=True),
        torch.zeros(K, requires_grad=True),
        torch.zeros(N, N, requires_grad=True),
    ]
    opt = torch.optim.Adam(tparams, lr=1e-3)
    opt.load_state_dict(ckpt["optimizer"])
    loss = sum((p ** 2).sum() for p in tparams[:4]) + tparams[0].sum()
    loss.backward()
    opt.step()  # raises if hyperparameters or param ids are malformed


def test_cli_convert_torch_to_npz(tmp_path):
    src = str(tmp_path / "final_refmodel.pth")
    _make_reference_checkpoint(src)
    dst = str(tmp_path / "migrated.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "gcn_maxcut", "convert", src, dst],
        capture_output=True, text=True, cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo", "HOME": "/root"},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"direction": "torch->npz"' in proc.stdout
    from gcn_maxcut.train import load_checkpoint

    cfg = TrainingConfig(n_nodes=N, hidden_dim=HID, learning_rate=2e-3)
    state = setup_train_state(cfg)
    params, opt_state, _, meta = load_checkpoint(dst, state.params, state.opt_state)
    assert meta["epoch"] == 42
    assert int(opt_state.inner_state[0].count) == 1

"""Two-way migration between reference PyTorch checkpoints and our pytrees.

The reference saves ``torch.save`` dicts
``{'epoch', 'model', 'optimizer', 'loss_history', 'inputs', 'config'}``
(``Training/TrainingNeural.py:451-458,625-633``) where ``model`` is the
``GCNSoftmax`` state_dict — DGL ``GraphConv`` stores ``convN.weight`` with
shape ``(in_feats, out_feats)`` and ``convN.bias`` ``(out_feats,)``, the
exact layout of our ``params["convN"]["w"/"b"]`` — ``inputs`` is the
(unused-in-forward) embedding table, and ``optimizer`` is the torch Adam
state (per-param ``step/exp_avg/exp_avg_sq``).

``load_torch_checkpoint`` converts all of that into our
``(params, opt_state, meta)`` so a reference user can resume a half-trained
model in JAX with bit-equivalent Adam moments; ``save_torch_checkpoint``
exports back into the reference's format (config as a ``SimpleNamespace``
so the reference's ``checkpoint['config'].field`` access works without our
classes installed).

The reference pickles its ``TrainingConfig`` *class instance* into the
checkpoint; unpickling normally requires that class on the path
(the reference works around PyTorch 2.6 ``weights_only`` with a
safe-globals fallback chain, ``TrainingNeural.py:583-597``).  We instead
load with a permissive unpickler that maps any ``*.TrainingConfig`` (or
other missing classes) onto an attribute-bag stub, then translate the
fields we know onto our own ``TrainingConfig``.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import types
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)

# reference state_dict param order under itertools.chain(net, embed)
# (``setup_model_and_optimizer``, TrainingNeural.py:336-337)
_PARAM_ORDER = [
    ("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b"),
    ("embed", None),
]


class _ConfigStub:
    """Attribute bag standing in for any unimportable pickled class."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and state and isinstance(state[0], dict):
            self.__dict__.update(state[0])


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            logger.info("stubbing unimportable pickled class %s.%s", module, name)
            return type(name, (_ConfigStub,), {})


class _PickleShim(types.ModuleType):
    """pickle_module for torch.load that uses the permissive unpickler."""

    Unpickler = _PermissiveUnpickler
    UnpicklingError = pickle.UnpicklingError

    @staticmethod
    def load(f, **kwargs):
        # forward torch.load's encoding (legacy py2-era .pth files are
        # latin1-encoded; dropping it would mis-decode them)
        enc = {"encoding": kwargs["encoding"]} if "encoding" in kwargs else {}
        return _PermissiveUnpickler(f, **enc).load()

    @staticmethod
    def loads(s, **kwargs):
        enc = {"encoding": kwargs["encoding"]} if "encoding" in kwargs else {}
        return _PermissiveUnpickler(io.BytesIO(s), **enc).load()


_pickle_shim = _PickleShim("gcn_maxcut._torch_pickle_shim")


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def config_from_torch(obj: Any) -> TrainingConfig:
    """Translate a reference TrainingConfig(-shaped) object onto ours."""
    if obj is None:
        return TrainingConfig()
    get = (obj.get if isinstance(obj, dict)
           else lambda k, d=None: getattr(obj, k, d))
    fields = {}
    for f in (
        "n_nodes", "dim_embedding", "hidden_dim", "dropout", "number_classes",
        "learning_rate", "number_epochs", "tolerance", "patience",
        "prob_threshold", "A", "C", "penalty", "save_directory",
        "save_frequency",
    ):
        v = get(f)
        if v is not None:
            fields[f] = v
    return TrainingConfig(**fields)


def load_torch_checkpoint(
    path: str,
    *,
    optimizer=None,
    params_template: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Any, Dict[str, Any]]:
    """Load a reference ``.pth`` checkpoint into our pytrees.

    Returns ``(params, opt_state, meta)``.  ``opt_state`` is None unless an
    optax ``optimizer`` (from ``setup_train_state``) and ``params_template``
    are given, in which case the torch Adam moments are grafted into a
    freshly initialized optax state (count = torch per-param step) so
    training resumes exactly where the reference left off.
    ``meta`` carries ``epoch``, ``loss_history``, and the translated
    ``config``.
    """
    import torch

    ckpt = torch.load(
        path, map_location="cpu", weights_only=False,
        pickle_module=_pickle_shim,
    )
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    params: Dict[str, Any] = {
        "conv1": {
            "w": jnp.asarray(_to_np(state["conv1.weight"])),
            "b": jnp.asarray(_to_np(state["conv1.bias"])),
        },
        "conv2": {
            "w": jnp.asarray(_to_np(state["conv2.weight"])),
            "b": jnp.asarray(_to_np(state["conv2.bias"])),
        },
    }
    inputs = ckpt.get("inputs") if isinstance(ckpt, dict) else None
    if inputs is not None:
        params["embed"] = jnp.asarray(_to_np(inputs))

    meta = {}
    if isinstance(ckpt, dict):
        meta["epoch"] = int(ckpt.get("epoch", 0))
        meta["loss_history"] = [
            float(x) for x in (
                ckpt.get("loss_history") or ckpt.get("lossList") or []
            )
        ]
        meta["config"] = config_from_torch(ckpt.get("config"))

    if isinstance(ckpt, dict) and ckpt.get("optimizer"):
        meta["torch_optimizer"] = ckpt["optimizer"]

    opt_state = None
    if optimizer is not None and params_template is not None \
            and isinstance(ckpt, dict) and ckpt.get("optimizer"):
        opt_state = adam_state_from_torch(
            optimizer, params_template, ckpt["optimizer"]
        )
    return params, opt_state, meta


def adam_state_from_torch(optimizer, params_template, torch_opt):
    """Graft torch Adam ``exp_avg/exp_avg_sq/step`` into an optax state.

    Moment shapes are validated against ``params_template`` so a checkpoint
    from a differently-sized model fails here, not later inside
    ``optimizer.update``.
    """
    init = optimizer.init(params_template)
    per_param = torch_opt.get("state", {})
    if not per_param:
        return init

    # torch ids are positions in chain(net.parameters(), embed.parameters())
    mu_upd: Dict[str, Any] = {}
    nu_upd: Dict[str, Any] = {}
    count = 0
    for idx, (group, leaf) in enumerate(_PARAM_ORDER):
        s = per_param.get(idx)
        if s is None:
            continue
        count = max(count, int(_to_np(s["step"]).reshape(-1)[0]))
        mu = jnp.asarray(_to_np(s["exp_avg"]))
        nu = jnp.asarray(_to_np(s["exp_avg_sq"]))
        tmpl = params_template.get(group)
        if leaf is not None and isinstance(tmpl, dict):
            tmpl = tmpl.get(leaf)
        if tmpl is not None and tuple(tmpl.shape) != tuple(mu.shape):
            raise ValueError(
                f"torch Adam moment {idx} ({group}/{leaf}) has shape "
                f"{tuple(mu.shape)}, template expects {tuple(tmpl.shape)}"
            )
        if leaf is None:
            mu_upd[group], nu_upd[group] = mu, nu
        else:
            mu_upd.setdefault(group, {})[leaf] = mu
            nu_upd.setdefault(group, {})[leaf] = nu

    masked = hasattr(init, "inner_state")
    inner = init.inner_state if masked else init
    adam = inner[0]
    new_mu = _merge(adam.mu, mu_upd)
    new_nu = _merge(adam.nu, nu_upd)
    adam = adam._replace(
        count=jnp.asarray(count, jnp.int32), mu=new_mu, nu=new_nu
    )
    new_inner = (adam,) + tuple(inner[1:])
    return init._replace(inner_state=new_inner) if masked else new_inner


def _merge(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    """Dict-tree merge that keeps untouched/masked leaves.

    A leaf in ``base`` that is not an array (e.g. ``optax.MaskedNode`` for
    the frozen embedding) is kept as-is — grafting a tensor there would
    corrupt the masked optimizer's state structure."""
    out = dict(base)
    for k, v in upd.items():
        if isinstance(v, dict):
            out[k] = _merge(base[k], v)
        elif hasattr(base.get(k), "shape"):
            out[k] = v
    return out


def save_torch_checkpoint(
    path: str,
    params: Dict[str, Any],
    *,
    epoch: int = 0,
    loss_history: Optional[List[float]] = None,
    config: Optional[TrainingConfig] = None,
    opt_state: Any = None,
) -> str:
    """Export our params (and optionally Adam state) to the reference's
    ``torch.save`` checkpoint layout so reference tooling can load it."""
    import torch

    def t(x):
        return torch.from_numpy(np.asarray(x).copy())

    state_dict = {
        "conv1.weight": t(params["conv1"]["w"]),
        "conv1.bias": t(params["conv1"]["b"]),
        "conv2.weight": t(params["conv2"]["w"]),
        "conv2.bias": t(params["conv2"]["b"]),
    }
    torch_opt: Dict[str, Any] = {"state": {}, "param_groups": []}
    if opt_state is not None:
        inner = opt_state.inner_state if hasattr(opt_state, "inner_state") \
            else opt_state
        adam = inner[0]
        step = torch.tensor(float(np.asarray(adam.count)))
        for idx, (group, leaf) in enumerate(_PARAM_ORDER):
            sub_mu = adam.mu.get(group)
            sub_nu = adam.nu.get(group)
            if leaf is not None and isinstance(sub_mu, dict):
                sub_mu, sub_nu = sub_mu.get(leaf), sub_nu.get(leaf)
            if sub_mu is None or not hasattr(sub_mu, "shape"):
                continue  # masked / absent param
            torch_opt["state"][idx] = {
                "step": step,
                "exp_avg": t(sub_mu),
                "exp_avg_sq": t(sub_nu),
            }
        # one group over ALL params in reference order (torch's
        # load_state_dict requires the group param count to match the
        # live optimizer — chain(net, embed) has 5 — and keeps the saved
        # hyperparameters, so they must be complete for opt.step())
        torch_opt["param_groups"] = [
            {
                "params": list(range(len(_PARAM_ORDER))),
                "lr": config.learning_rate if config is not None else 1e-3,
                "betas": (0.9, 0.999),
                "eps": 1e-8,
                "weight_decay": 0.0,
                "amsgrad": False,
                "maximize": False,
                "foreach": None,
                "capturable": False,
                "differentiable": False,
                "fused": None,
            }
        ]

    ckpt = {
        "epoch": epoch,
        "model": state_dict,
        "optimizer": torch_opt,
        "loss_history": list(loss_history or []),
        "inputs": t(params["embed"]) if "embed" in params else None,
        "config": types.SimpleNamespace(**dataclasses.asdict(config))
        if config is not None else None,
    }
    torch.save(ckpt, path)
    logger.info("exported torch checkpoint to %s", path)
    return path

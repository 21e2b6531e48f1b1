"""Per-layer activation + gradient parity against torch numerics.

BASELINE.json's north star asks for per-layer activation parity
(`allclose`) with the reference pipeline.  DGL itself is not installed
here, so this re-implements the documented GraphConv semantics
(norm='both': h' = D̃^{-1/2} A D̃^{-1/2} X W + b, no self-loops, degree
clamp) and the reference's straight-through formulas in torch (CPU), runs
both frameworks with identical weights, and compares every layer's
activations and the end-to-end loss gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from gcn_maxcut.core import graph_from_dense, dense_adjacency
from gcn_maxcut.models import gcn_softmax_init
from gcn_maxcut.models.gcn import gcn_conv_apply
from gcn_maxcut.objectives import compute_loss
from gcn_maxcut.ops import pin_terminals, ste_argmax_onehot


def _random_graph(n=30, p=0.3, seed=0):
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    a = a + a.T
    return graph_from_dense(a), a


def _torch_graphconv(adj_t, x_t, w_t, b_t):
    deg = adj_t.sum(dim=1).clamp(min=1.0)
    norm = deg.pow(-0.5).unsqueeze(1)
    return norm * (adj_t @ (norm * (x_t @ w_t))) + b_t


def test_per_layer_activations_allclose():
    g, a = _random_graph()
    n = a.shape[0]
    params = gcn_softmax_init(jax.random.PRNGKey(0), 16, 8, 3)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 16)).astype(np.float32)

    # torch side
    adj_t = torch.tensor(a)
    x_t = torch.tensor(x)
    w1 = torch.tensor(np.asarray(params["conv1"]["w"]))
    b1 = torch.tensor(np.asarray(params["conv1"]["b"]))
    w2 = torch.tensor(np.asarray(params["conv2"]["w"]))
    b2 = torch.tensor(np.asarray(params["conv2"]["b"]))

    h1_t = _torch_graphconv(adj_t, x_t, w1, b1)
    r_t = torch.relu(h1_t)
    h2_t = _torch_graphconv(adj_t, r_t, w2, b2)
    probs_t = torch.softmax(h2_t, dim=1)

    # jax side, layer by layer
    xj = jnp.zeros((g.n_pad, 16)).at[:n].set(x)
    h1 = gcn_conv_apply(params["conv1"], g, xj)
    np.testing.assert_allclose(
        np.asarray(h1[:n]), h1_t.numpy(), rtol=1e-4, atol=1e-5
    )
    r = jax.nn.relu(h1)
    h2 = gcn_conv_apply(params["conv2"], g, r)
    np.testing.assert_allclose(
        np.asarray(h2[:n]), h2_t.numpy(), rtol=1e-4, atol=1e-5
    )
    probs = jax.nn.softmax(h2, axis=-1)
    np.testing.assert_allclose(
        np.asarray(probs[:n]), probs_t.numpy(), rtol=1e-4, atol=1e-6
    )


def test_ste_loss_gradient_matches_torch():
    """The full loss chain's gradient wrt the softmax output must equal
    torch autograd through the reference's detach algebra."""
    g, a = _random_graph(n=12, p=0.4, seed=2)
    n = a.shape[0]
    rng = np.random.default_rng(3)
    probs_np = rng.dirichlet([1.0, 1.0, 1.0], size=n).astype(np.float32)

    # --- torch: reference formulas (override_fixed_nodes / max_to_one_hot /
    # HC = sum(A*(1-S Sᵀ))/2, loss = -HC) written from their math ---
    h = torch.tensor(probs_np, requires_grad=True)
    out = h.clone()
    eye = torch.eye(3)
    for i in range(3):
        out[i] = eye[i] + h[i] - h[i].detach()
    rows = []
    for i in range(n):
        onehot = torch.zeros(3)
        onehot[torch.argmax(out[i])] = 1.0
        rows.append(onehot + out[i] - out[i].detach())
    s_t = torch.stack(rows)
    adj_t = torch.tensor(a)
    hc = (adj_t * (1 - s_t @ s_t.T)).sum() / 2
    loss_t = -hc
    loss_t.backward()
    grad_t = h.grad.numpy()

    # --- jax: the framework chain ---
    def loss_fn(probs):
        s = ste_argmax_onehot(pin_terminals(probs))
        return compute_loss(g, s)

    probs_j = jnp.zeros((g.n_pad, 3)).at[:n].set(probs_np)
    loss_j, grad_j = jax.value_and_grad(loss_fn)(probs_j)

    np.testing.assert_allclose(float(loss_j), float(loss_t), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grad_j[:n]), grad_t, rtol=1e-4, atol=1e-5
    )


def test_adam_step_matches_torch():
    """One Adam step on identical params/grads: optax vs torch.optim."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    grad = rng.normal(size=(6, 4)).astype(np.float32)

    w_t = torch.tensor(w, requires_grad=True)
    opt_t = torch.optim.Adam([w_t], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    w_t.grad = torch.tensor(grad)
    opt_t.step()

    import optax

    opt_j = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = opt_j.init(jnp.asarray(w))
    updates, _ = opt_j.update(jnp.asarray(grad), state, jnp.asarray(w))
    w_j = optax.apply_updates(jnp.asarray(w), updates)

    np.testing.assert_allclose(
        np.asarray(w_j), w_t.detach().numpy(), rtol=1e-5, atol=1e-6
    )

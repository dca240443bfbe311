"""PyTorch port, optimizers: the port's phase optimizers (``models/common.
make_optimizer``: Keras Adam, RMSprop with rho 0.9 and eps 1e-7 outside the
square root, SGD) against the JAX package's ``TrainPhase.make_tx`` over
six steps of random gradients, some of them tiny (where the placement of
eps decides the update), with one layer frozen and the learning rate
halved after the third step (ReduceLROnPlateau's ``scale_learning_rate``).

A frozen layer never moves, never requires grad and gets no optimizer
state. Tolerance: parameters within 1e-6 relative plus 1e-4 of the
learning rate: float32 on both sides, the same operations in other orders;
Adam's bias correction ``1 - b2^t`` cancels (at t = 2 one ulp of ``b2^t``
moves it by ~3e-5 relative), and numpy's and XLA's float32 powers may
differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ab_line_classifier_tpu.models import common as jax_C
from ab_line_classifier_torch.models import common as C

SHAPES = {"conv": (3, 3, 4, 8), "dense": (8, 2)}
TRAINABLE = {"conv": True, "dense": True, "frozen": False}
LR = 3e-3
STEPS = 6


def params(seed=0):
    rng = np.random.RandomState(seed)
    p = {name: {"kernel": rng.normal(0, 0.3, shape).astype(np.float32)}
         for name, shape in SHAPES.items()}
    p["frozen"] = {"kernel": rng.normal(0, 0.3, (5,)).astype(np.float32)}
    return p


def grads(step, seed=1):
    """Random gradients; a quarter of the elements around 1e-7 in size."""
    rng = np.random.RandomState(seed + step)
    out = {}
    for name, leaf in params().items():
        g = rng.normal(0, 0.1, leaf["kernel"].shape)
        tiny = rng.rand(*g.shape) < 0.25
        g[tiny] *= 1e-6
        out[name] = {"kernel": g.astype(np.float32)}
    return out


def module(p):
    m = torch.nn.Module()
    for name, leaf in p.items():
        sub = torch.nn.Module()
        sub.weight = torch.nn.Parameter(torch.tensor(leaf["kernel"]))
        m.add_module(name, sub)
    return m


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop", "sgd"])
def test_optimizer_matches_jax(optimizer):
    p0 = params()
    jax_phase = jax_C.TrainPhase(name="t", optimizer=optimizer, lr=LR,
                                 trainable=TRAINABLE)
    tx = jax_phase.make_tx()
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)

    m = module(p0)
    opt = C.make_optimizer(C.TrainPhase(name="t", optimizer=optimizer,
                                        lr=LR, trainable=TRAINABLE), m)
    assert not m.frozen.weight.requires_grad
    assert m.conv.weight.requires_grad and m.dense.weight.requires_grad

    for step in range(STEPS):
        if step == 3:
            state = jax_C.scale_learning_rate(state, 0.5)
            C.scale_learning_rate(opt, 0.5)
            assert C.get_learning_rate(opt) == pytest.approx(
                jax_C.get_learning_rate(state), rel=1e-7)
        g = grads(step)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name in ("conv", "dense"):
            getattr(m, name).weight.grad = torch.tensor(g[name]["kernel"])
        opt.step()
        for name in ("conv", "dense"):
            np.testing.assert_allclose(
                getattr(m, name).weight.detach().numpy(),
                np.asarray(jp[name]["kernel"]), rtol=1e-6, atol=1e-4 * LR,
                err_msg=f"{optimizer} step {step} {name}")
    np.testing.assert_array_equal(m.frozen.weight.detach().numpy(),
                                  p0["frozen"]["kernel"])
    assert m.frozen.weight not in opt.state
    assert all(p is not m.frozen.weight
               for group in opt.param_groups for p in group["params"])


def test_keras_adam_is_not_torch_adam():
    """Where the gradient is tiny, the placement of eps decides the step:
    ``torch.optim.Adam`` (eps added to the corrected moment's root) moves
    such an element otherwise than Keras's Adam."""
    g = torch.tensor([1e-7, 1e-3, 0.3])
    steps = {}
    for name, cls in (("keras", C.KerasAdam), ("torch", torch.optim.Adam)):
        w = torch.nn.Parameter(torch.zeros(3))
        opt = cls([w], lr=1.0, eps=1e-7)
        w.grad = g.clone()
        opt.step()
        steps[name] = w.detach().numpy()
    # Keras: -m alpha / (sqrt(v) + eps) with m = 0.1 g, sqrt(v) = 0.0316 |g|,
    # alpha = 0.316: -0.0316 g / (0.0316 |g| + 1e-7).
    keras = -0.1 * g.numpy() * 0.31622776 / (0.031622776 * g.numpy() + 1e-7)
    np.testing.assert_allclose(steps["keras"], keras, rtol=1e-5)
    assert abs(steps["keras"][0] - steps["torch"][0]) > 0.1

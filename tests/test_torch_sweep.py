"""PyTorch port, the sweep controllers (``train/sweep.py``): for each
method and each model's ``HPARAM_SEARCH`` space in ``config.yml`` (and a
small grid that runs out), the same seed and the same deterministic
objective give exactly the JAX package's suggestions, trial by trial,
``SweepExhausted`` at the same trial, the same GP partial dependence, and
after ``replay_trials`` of the finished records the same controller state
(random generator, grid cursor, history) and the same next suggestion.
"""

import math
import os

import numpy as np
import pytest

from conftest import REPO_ROOT

from ab_line_classifier_tpu.train import sweep as J
from ab_line_classifier_torch.config import load_config
from ab_line_classifier_torch.train import sweep as S

CFG = load_config(os.path.join(REPO_ROOT, "config.yml"))
SPACES = {name: CFG["HPARAM_SEARCH"][name].to_dict()
          for name in CFG["HPARAM_SEARCH"]}
SPACES["SMALL_GRID"] = {"OPT": {"TYPE": "set", "RANGE": ["adam", "sgd"]},
                        "BLOCKS": {"TYPE": "int_uniform", "RANGE": [1, 2]}}
N_TRIALS = {"random": 8, "grid": 8, "bayes": 6}


def objective(params):
    """A smooth deterministic function of every parameter kind."""
    total = 0.0
    for k, v in sorted(params.items()):
        if isinstance(v, str):
            total += 0.3 * len(v)
        elif isinstance(v, float) and v > 0:
            total -= (math.log10(v) + 3.3) ** 2 + v
        else:
            total -= 0.1 * (float(v) - 3.0) ** 2
    return total


def run(mod, method, space_cfg, n, seed=10001):
    ctl = mod.make_controller(method, mod.space_from_config(space_cfg), seed)
    seq, exhausted_at = [], None
    for trial in range(n):
        try:
            params = ctl.suggest()
        except mod.SweepExhausted:
            exhausted_at = trial
            break
        ctl.observe(params, objective(params))
        seq.append(params)
    return ctl, seq, exhausted_at


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("method", ["random", "grid", "bayes"])
def test_suggestions_match_jax(method, space):
    space_cfg = SPACES[space]
    assert [vars(v) for v in S.space_from_config(space_cfg)] == [
        vars(v) for v in J.space_from_config(space_cfg)]
    ctl, got, got_end = run(S, method, space_cfg, N_TRIALS[method])
    ref, want, want_end = run(J, method, space_cfg, N_TRIALS[method])
    assert got == want and got_end == want_end
    assert [type(v) for p in got for v in p.values()] == [
        type(v) for p in want for v in p.values()]
    assert ctl.best == ref.best
    if space == "SMALL_GRID" and method == "grid":
        assert got_end == 4 and len(ctl) == 4
    if method == "bayes":
        for var in ctl.space:
            values, pd = ctl.partial_dependence(var.name, n_points=9,
                                                n_samples=16)
            ref_values, ref_pd = ref.partial_dependence(var.name, n_points=9,
                                                        n_samples=16)
            assert values == ref_values
            np.testing.assert_array_equal(pd, ref_pd)


@pytest.mark.parametrize("done", [1, 3, 4])
@pytest.mark.parametrize("method", ["random", "grid", "bayes"])
def test_replayed_controllers_continue_like_jax(method, done):
    """Records of ``done`` finished trials (as a trials file holds them)
    replayed into fresh controllers: the same state, and the next
    suggestions of the uninterrupted run."""
    space_cfg = SPACES["CUTOFFVGG16"] if method != "grid" else SPACES[
        "SMALL_GRID"]
    _, full, _ = run(J, method, space_cfg, done + 2)
    records = [{"trial": i, **p, "objective": objective(p)}
               for i, p in enumerate(full[:done])]
    ctl = S.make_controller(method, S.space_from_config(space_cfg), 10001)
    ref = J.make_controller(method, J.space_from_config(space_cfg), 10001)
    S.replay_trials(ctl, records)
    J.replay_trials(ref, records)
    assert ctl.history == ref.history
    got_state, want_state = ctl.rng.get_state(), ref.rng.get_state()
    np.testing.assert_array_equal(got_state[1], want_state[1])
    assert got_state[2:] == want_state[2:]
    if method == "grid":
        assert ctl._i == ref._i
    nxt = []
    for c in (ctl, ref):
        try:
            nxt.append(c.suggest())
        except (S.SweepExhausted, J.SweepExhausted) as e:
            nxt.append(type(e).__name__)
    assert nxt[0] == nxt[1]
    if done + 1 <= len(full):
        assert nxt[0] == full[done]

"""Hyperparameter-sweep controllers: grid, random and Bayesian (GP + EI)
(a copy of the JAX package's ``train/sweep.py``, numpy only, so that the
same seed and the same observations give the same suggestions).

The reference delegates sweeps to the W&B service, and its legacy path runs
skopt's ``gp_minimize(acq_func='EI')``. Neither is a dependency here: the
controllers implement the same search-space semantics (``set`` ->
categorical, ``int_uniform``, ``float_uniform``, ``float_log``) and a
Gaussian-process expected-improvement optimizer in numpy.

GP details: Matern-5/2 kernel on the unit-cube-normalized space (log-space
for ``float_log`` variables, one-hot for categoricals), observation noise
1e-6, EI maximized over random candidate draws and jittered copies of the
incumbent. Seeded controllers make sweeps reproducible.
"""

from __future__ import annotations

import dataclasses
import math
from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SweepVar:
    name: str
    type: str                     # set | int_uniform | float_uniform | float_log
    range: Tuple

    def __post_init__(self):
        if self.type not in ("set", "int_uniform", "float_uniform",
                             "float_log"):
            raise ValueError(f"unknown sweep TYPE {self.type!r} for {self.name}")

    # unit-cube encoding ---------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.range) if self.type == "set" else 1

    def sample(self, rng: np.random.RandomState) -> Any:
        if self.type == "set":
            return self.range[rng.randint(len(self.range))]
        lo, hi = self.range
        if self.type == "int_uniform":
            return int(rng.randint(int(lo), int(hi) + 1))
        if self.type == "float_uniform":
            return float(rng.uniform(lo, hi))
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))

    def encode(self, value: Any) -> np.ndarray:
        if self.type == "set":
            v = np.zeros(len(self.range))
            v[list(self.range).index(value)] = 1.0
            return v
        lo, hi = self.range
        if self.type == "int_uniform":
            return np.array([(value - lo) / max(hi - lo, 1e-12)])
        if self.type == "float_uniform":
            return np.array([(value - lo) / max(hi - lo, 1e-12)])
        return np.array([(math.log(value) - math.log(lo))
                         / max(math.log(hi) - math.log(lo), 1e-12)])

    def decode(self, u: np.ndarray) -> Any:
        if self.type == "set":
            return self.range[int(np.argmax(u))]
        x = float(np.clip(u[0], 0.0, 1.0))
        lo, hi = self.range
        if self.type == "int_uniform":
            return int(round(lo + x * (hi - lo)))
        if self.type == "float_uniform":
            return float(lo + x * (hi - lo))
        return float(np.exp(math.log(lo) + x * (math.log(hi) - math.log(lo))))


def space_from_config(search_cfg: Dict[str, Dict]) -> List[SweepVar]:
    """Parse an HPARAM_SEARCH model section (reference config.yml:157-193)."""
    out = []
    for name, spec in search_cfg.items():
        if not isinstance(spec, dict) or spec.get("RANGE") is None:
            continue
        out.append(SweepVar(name=name, type=spec["TYPE"],
                            range=tuple(spec["RANGE"])))
    return out


class SweepExhausted(Exception):
    """Raised by suggest() when the search space has no new configurations
    (finite grids). W&B grid agents stop at exhaustion rather than re-running
    duplicates (reference train.py:364-368 semantics); callers should end
    the sweep."""


class Controller:
    """suggest() -> params dict; observe(params, objective) records it.
    Objectives are always *maximized* (callers negate for minimize)."""

    def __init__(self, space: Sequence[SweepVar], seed: int = 0):
        self.space = list(space)
        self.rng = np.random.RandomState(seed)
        self.history: List[Tuple[Dict[str, Any], float]] = []

    def suggest(self) -> Dict[str, Any]:
        raise NotImplementedError

    def observe(self, params: Dict[str, Any], objective: float) -> None:
        self.history.append((dict(params), float(objective)))

    @property
    def best(self) -> Optional[Tuple[Dict[str, Any], float]]:
        if not self.history:
            return None
        return max(self.history, key=lambda kv: kv[1])

    def _encode(self, params: Dict[str, Any]) -> np.ndarray:
        return np.concatenate([v.encode(params[v.name]) for v in self.space])

    def _decode(self, u: np.ndarray) -> Dict[str, Any]:
        out = {}
        i = 0
        for v in self.space:
            out[v.name] = v.decode(u[i:i + v.dim])
            i += v.dim
        return out

    def _random_params(self) -> Dict[str, Any]:
        return {v.name: v.sample(self.rng) for v in self.space}


class RandomController(Controller):
    def suggest(self) -> Dict[str, Any]:
        return self._random_params()


class GridController(Controller):
    """Cartesian grid. Continuous vars are discretized to ``grid_points``
    levels; ``set``/int vars enumerate exactly. W&B 'grid' requires discrete
    values, so this is a superset of the reference's behavior."""

    def __init__(self, space, seed: int = 0, grid_points: int = 5):
        super().__init__(space, seed)
        axes = []
        for v in self.space:
            if v.type == "set":
                axes.append(list(v.range))
            elif v.type == "int_uniform":
                lo, hi = int(v.range[0]), int(v.range[1])
                axes.append(list(range(lo, hi + 1)))
            else:
                us = np.linspace(0, 1, grid_points)
                axes.append([v.decode(np.array([u])) for u in us])
        self._grid = list(product(*axes))
        self._i = 0

    def __len__(self):
        return len(self._grid)

    def observe(self, params: Dict[str, Any], objective: float) -> None:
        super().observe(params, objective)
        # Resumed sweeps replay completed trials through observe() without
        # suggest(); keep the grid cursor past everything already run.
        self._i = max(self._i, len(self.history))

    def suggest(self) -> Dict[str, Any]:
        if self._i >= len(self._grid):
            raise SweepExhausted(
                f"grid exhausted after {len(self._grid)} configurations")
        vals = self._grid[self._i]
        self._i += 1
        return {v.name: val for v, val in zip(self.space, vals)}


class BayesController(Controller):
    """GP + expected improvement, the in-process analogue of
    ``gp_minimize(acq_func='EI')`` (reference train_legacy.py:575-588)."""

    def __init__(self, space, seed: int = 0, n_initial: int = 3,
                 n_candidates: int = 2048):
        super().__init__(space, seed)
        self.n_initial = n_initial
        self.n_candidates = n_candidates

    def _kernel(self, A: np.ndarray, B: np.ndarray, ls: float) -> np.ndarray:
        d = np.sqrt(np.maximum(
            ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1), 0.0)) / ls
        sq5 = math.sqrt(5.0)
        return (1 + sq5 * d + 5.0 / 3.0 * d * d) * np.exp(-sq5 * d)

    def _fit_posterior(self):
        """Fit the GP to the history; returns (predict_fn, X, L, ls) where
        ``predict_fn(U) -> (mu, sigma)`` evaluates the posterior at encoded
        points U (de-normalized back to objective units)."""
        X = np.stack([self._encode(p) for p, _ in self.history])
        y = np.array([o for _, o in self.history], dtype=np.float64)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std
        ls = 0.25 * math.sqrt(X.shape[1])
        K = self._kernel(X, X, ls) + 1e-6 * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        def predict(U: np.ndarray):
            Kc = self._kernel(U, X, ls)
            mu = Kc @ alpha
            v = np.linalg.solve(L, Kc.T)
            var = np.maximum(
                self._kernel(U, U, ls).diagonal() - (v ** 2).sum(0), 1e-12)
            return mu * y_std + y_mean, np.sqrt(var) * y_std

        return predict, X, L, ls

    def partial_dependence(self, var_name: str, n_points: int = 40,
                           n_samples: int = 128, seed: int = 0):
        """1-D partial dependence of the GP posterior mean on one variable:
        sweep it over its range while marginalizing the others with random
        draws — the data behind skopt's ``plot_objective`` diagonal
        (reference ``src/visualization/visualization.py:142-178``).
        Returns (values, pd_mean) in the variable's native units."""
        if len(self.history) < 2:
            raise ValueError("need >= 2 observations for partial dependence")
        predict, _, _, _ = self._fit_posterior()
        var = next(v for v in self.space if v.name == var_name)
        i0 = sum(v.dim for v in self.space[: self.space.index(var)])
        rng = np.random.RandomState(seed)
        samples = np.stack([
            self._encode(self._random_with(rng)) for _ in range(n_samples)])
        if var.type == "set":
            grid_u = list(np.eye(len(var.range)))
        else:
            grid_u = [np.array([u]) for u in np.linspace(0, 1, n_points)]
        values, pd = [], []
        for u in grid_u:
            U = samples.copy()
            U[:, i0:i0 + var.dim] = u
            mu, _ = predict(U)
            values.append(var.decode(np.asarray(u)))
            pd.append(float(mu.mean()))
        return values, np.asarray(pd)

    def _random_with(self, rng) -> Dict[str, Any]:
        return {v.name: v.sample(rng) for v in self.space}

    def suggest(self) -> Dict[str, Any]:
        if len(self.history) < self.n_initial:
            return self._random_params()
        predict, _, _, _ = self._fit_posterior()

        # candidate pool: random + jittered copies of the incumbent
        cand_params = [self._random_params()
                       for _ in range(self.n_candidates // 2)]
        best_u = self._encode(self.best[0])
        for _ in range(self.n_candidates // 2):
            jitter = self.rng.randn(len(best_u)) * 0.1
            cand_params.append(self._decode(np.clip(best_u + jitter, 0, 1)))
        Xc = np.stack([self._encode(p) for p in cand_params])

        # EI for maximization (invariant to the posterior's affine
        # de-normalization, so objective units are fine here).
        mu, sigma = predict(Xc)
        best_y = max(o for _, o in self.history)
        z = (mu - best_y) / sigma
        from math import erf
        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        ei = sigma * (z * cdf + pdf)
        return cand_params[int(np.argmax(ei))]


def replay_trials(controller: Controller, records: Sequence[Dict]) -> None:
    """Feed completed-trial records into a fresh controller so a resumed
    sweep continues the uninterrupted run's trajectory.

    Each record replays as one ``suggest()`` (discarded) + ``observe()`` —
    the exact call pattern of the original run. The discarded suggest is
    the point: it advances the controller's rng/cursor state, so the next
    live ``suggest()`` proposes what the uninterrupted run would have
    proposed. Observing alone would leave random/bayes controllers on a
    fresh seed, re-proposing the original run's first params — a resumed
    sweep silently re-training duplicate configurations.
    """
    for rec in records:
        params = {k: v for k, v in rec.items()
                  if k not in ("trial", "objective")}
        try:
            controller.suggest()
        except SweepExhausted:
            pass
        controller.observe(params, rec["objective"])


def make_controller(method: str, space: Sequence[SweepVar],
                    seed: int = 0) -> Controller:
    method = method.lower()
    if method == "bayes":
        return BayesController(space, seed)
    if method == "grid":
        return GridController(space, seed)
    if method == "random":
        return RandomController(space, seed)
    raise ValueError(f"unknown sweep METHOD {method!r}")

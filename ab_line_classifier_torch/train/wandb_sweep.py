"""The W&B sweep service as the hyperparameter search's scheduler (port of
the JAX package's ``train/wandb_sweep.py``), selected by
``TRAIN.HPARAM_SEARCH.BACKEND: wandb``.

:func:`wandb_sweep_config` translates an ``HPARAM_SEARCH`` model section
into a W&B sweep config by the reference's mapping: ``set`` -> categorical
values, ``int_uniform`` -> int_uniform min/max, ``float_log`` ->
log_uniform_values, ``float_uniform`` -> uniform. :func:`run_wandb_sweep`
registers the sweep (or attaches to one by ``sweep_id``) and lets
``wandb.agent`` call one training run per trial. wandb is not a
dependency: it is imported only when no ``wandb_module=`` stand-in is
given, and ``hparam_search`` runs the native controllers where it does
not import.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional


def wandb_sweep_config(method: str, metric_goal: str, metric_name: str,
                       search_cfg: Dict[str, Dict]) -> Dict[str, Any]:
    """Translate an ``HPARAM_SEARCH`` model section into a W&B sweep config
    dict (reference ``configure_hyperparameter_sweep``, train.py:268-296)."""
    out: Dict[str, Any] = {
        "method": method,
        "metric": {"goal": metric_goal, "name": metric_name},
        "parameters": {},
    }
    for name, spec in search_cfg.items():
        if not isinstance(spec, dict) or spec.get("RANGE") is None:
            continue
        stype, rng = spec["TYPE"], spec["RANGE"]
        if stype == "set":
            pcfg = {"distribution": "categorical", "values": list(rng)}
        elif stype == "int_uniform":
            pcfg = {"distribution": "int_uniform",
                    "min": rng[0], "max": rng[1]}
        elif stype == "float_log":
            pcfg = {"distribution": "log_uniform_values",
                    "min": rng[0], "max": rng[1]}
        elif stype == "float_uniform":
            pcfg = {"distribution": "uniform",
                    "min": rng[0], "max": rng[1]}
        else:
            raise ValueError(f"unknown sweep TYPE {stype!r} for {name}")
        out["parameters"][name] = pcfg
    return out


def _default_wandb():
    try:
        import wandb
    except ImportError as e:  # wandb is optional
        raise ImportError(
            "wandb is not installed; use the native sweep controllers "
            "(TRAIN.HPARAM_SEARCH.BACKEND: native) or pass wandb_module=") \
            from e
    return wandb


def run_wandb_sweep(cfg, *, save_weights: bool = False, verbose: bool = True,
                    count: Optional[int] = None, wandb_module=None,
                    run_fn: Optional[Callable] = None,
                    sweep_id: Optional[str] = None, device=None,
                    source=None) -> Dict[str, Any]:
    """Register a sweep with the W&B service and let its agent schedule
    trials (the reference's exact control flow, train.py:355-364); each
    trial runs :func:`perform_single_run` with the service-chosen
    hyperparameters and reports the objective metric back so bayes sweeps
    steer.

    :param wandb_module: a ``wandb``-like module (``sweep``/``agent``/
        ``init``/``log`` surface); the default imports wandb.
    :param run_fn: trial runner, called as ``run_fn(cfg, hparam_overrides=,
        save_weights=, group=, verbose=)``; the default is
        :func:`perform_single_run` on ``device``, every trial on
        ``source`` (a ``FoldSource``; default: :func:`source_from_datasets`,
        resolved once).
    :param sweep_id: attach the agent to an EXISTING service sweep instead
        of registering a new one — the W&B resume contract (the service
        owns the trial history; the reference reads the analogous
        ``WANDB_SWEEP_ID``, reference train.py:192).
    :returns: ``{"sweep_id", "trials", "best", "best_params",
        "best_objective"}`` — the last two mirror the native
        :func:`~ab_line_classifier_torch.train.experiment.hparam_search`
        result shape so callers read one contract regardless of BACKEND.
    """
    from ab_line_classifier_torch.train import experiment as E

    wandb = wandb_module if wandb_module is not None else _default_wandb()
    if run_fn is None:
        def run_fn(cfg, **kw):
            nonlocal source
            if source is None:
                source = E.source_from_datasets(cfg)
            return E.perform_single_run(cfg, kfold_tables=source,
                                        device=device, **kw)
    search = cfg["TRAIN"]["HPARAM_SEARCH"]
    if sweep_id is None:
        sweep_cfg = wandb_sweep_config(search["METHOD"],
                                       search["METRIC_GOAL"],
                                       search["METRIC_NAME"],
                                       cfg.hparam_search_space())
        sweep_id = wandb.sweep(sweep=sweep_cfg,
                               project=cfg["WANDB"]["PROJECT_NAME"],
                               # .get: an absent ENTITY means the account's
                               # default entity (same treatment as the
                               # tracker, tracker.py WandbTracker).
                               entity=cfg["WANDB"].get("ENTITY") or None)
    else:
        if verbose:
            print(f"attaching agent to existing wandb sweep {sweep_id}")
        # Best-effort cross-check: a local config.yml edited since the
        # sweep was registered (different METRIC_NAME / METHOD) would make
        # every trial log a metric the service's optimizer is not steering
        # on — a silent degeneration to random search. The Api surface is
        # optional (absent from minimal mocks and offline installs).
        try:
            svc = wandb.Api().sweep(sweep_id).config
        except Exception:
            svc = None
        if isinstance(svc, dict):
            svc_metric = (svc.get("metric") or {}).get("name")
            if svc_metric and svc_metric != search["METRIC_NAME"]:
                warnings.warn(
                    f"local METRIC_NAME {search['METRIC_NAME']!r} differs "
                    f"from the service sweep's registered metric "
                    f"{svc_metric!r}; its optimizer will not see the "
                    f"values these trials log")
            svc_method = svc.get("method")
            if svc_method and svc_method != search["METHOD"]:
                warnings.warn(
                    f"local METHOD {search['METHOD']!r} differs from the "
                    f"service sweep's registered method {svc_method!r}; "
                    f"the service's method wins")
    trials: List[Dict[str, Any]] = []

    def trial():
        run = wandb.init()
        params = dict(run.config)
        if verbose:
            print(f"--- wandb sweep trial {len(trials)}: {params}")
        result = run_fn(cfg, hparam_overrides=params,
                        save_weights=save_weights, group=str(sweep_id),
                        verbose=verbose)
        obj = E._sweep_objective(result, search["METRIC_NAME"],
                                 search["METRIC_GOAL"])
        # The sweep service optimizes the RAW metric it was configured
        # with; the signed objective stays local. When the run produced no
        # such metric, log the fallback under ITS OWN name — logging the
        # val_auc substitute under METRIC_NAME would hand a minimize-goal
        # bayes sweep a flipped-sign foreign quantity to steer on.
        raw = E._extract_raw_metric(result, search["METRIC_NAME"])
        if raw is not None:
            wandb.log({search["METRIC_NAME"]: raw})
        else:
            wandb.log({"val_auc": float(result.best_val.get("val_auc",
                                                            0.0))})
        run.finish()
        trials.append({**params, "objective": obj})

    wandb.agent(sweep_id, function=trial,
                count=count if count is not None else int(search["N_EVALS"]))
    best = max(trials, key=lambda t: t["objective"]) if trials else None
    return {"sweep_id": sweep_id, "trials": trials, "best": best,
            "best_params": ({k: v for k, v in best.items()
                             if k != "objective"} if best else None),
            "best_objective": best["objective"] if best else None}

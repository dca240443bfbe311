"""CLI entry point: ``python -m ab_line_classifier_torch.train``.

Runs TRAIN.EXPERIMENT_TYPE from the config, or ``--experiment``:
``single_train`` saves a port checkpoint under ``PATHS.MODEL_WEIGHTS``;
``cross_validation`` and ``hparam_search`` run one training per fold or
trial and write their records and summary CSV under
``PATHS.EXPERIMENTS`` (``--resume`` skips the folds or trials that an
interrupted run finished). With ``--trial-parallel`` they train every
fold, or every learning-rate trial, at once as one stacked model
(``kfold_parallel_*.csv`` / ``lr_sweep_parallel_*.csv``; ``--resume``
continues from the per-epoch checkpoint). ``--device`` picks the
device (default ``cuda``: without a GPU the command raises unless given
``--device cpu``); ``--profile`` writes a ``torch.profiler`` trace under
``<PATHS.LOGS>/profiles``.
"""

import argparse

from ab_line_classifier_torch.config import load_config


def main():
    p = argparse.ArgumentParser(description="Train the A/B-line classifier")
    p.add_argument("--config", default=None, help="path to config.yml")
    p.add_argument("--experiment", default=None,
                   choices=["single_train", "cross_validation",
                            "hparam_search"],
                   help="override TRAIN.EXPERIMENT_TYPE")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train on (default cuda; there is no "
                        "silent fallback to the CPU)")
    p.add_argument("--no-save-weights", action="store_true")
    p.add_argument("--trial-parallel", action="store_true",
                   help="cross_validation / hparam_search: train all folds "
                        "/ LR trials at once as one stacked model")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the whole train state here every epoch")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: restore the per-epoch "
                        "checkpoint (single_train and --trial-parallel; from "
                        "--checkpoint-dir, default "
                        "<MODEL_WEIGHTS>/_resume/<experiment>) or skip the "
                        "finished trials / folds (serial hparam_search / "
                        "cross_validation)")
    p.add_argument("--sweep-id", default=None,
                   help="name of the sweep / k-fold run to create or resume "
                        "(default on --resume: the most recent one)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the run to "
                        "<PATHS.LOGS>/profiles")
    args = p.parse_args()

    cfg = load_config(args.config)

    from ab_line_classifier_torch.train.experiment import train_experiment
    from ab_line_classifier_torch.utils.profiling import run_maybe_traced

    def run():
        train_experiment(cfg, experiment=args.experiment,
                         save_weights=not args.no_save_weights,
                         trial_parallel=args.trial_parallel,
                         checkpoint_dir=args.checkpoint_dir,
                         resume=args.resume, sweep_id=args.sweep_id,
                         device=args.device)

    run_maybe_traced(run, args.profile, cfg)


if __name__ == "__main__":
    main()

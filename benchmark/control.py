"""The upper readings of a cell's checks: the control and the faults,
read at the cell's own size, one JSON line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 21,22,23

The control is the plain reference put in the program's place, computed a
step below the configurations' bfloat16: float8 (each conv and dense
input, weight and output in e4m3, gradients in e5m2, per-tensor scales).
Its outputs are judged by the run's own comparison against the float32
reference, on the run's own weights and traffic: in the fit cells the
set-up's read steps and the validation frames from the seeded weights.
The fit cells' faults are planted in the reference put in the program's
place: half of each batch left out of the loss, the mean taken over the
rest. A state left unchanged
reads 1 on ``delta_gap`` by the measure's definition and needs no run. The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _half_batch(losses):
    """``reference.train.example_losses`` with the second half of a
    training batch left out: the mean is taken over the rest."""
    def wrapped(model, config, x, labels, class_weight, generator=None):
        per = losses(model, config, x, labels, class_weight, generator)
        return per if generator is None else per[:per.shape[0] // 2]
    return wrapped


def readings(cell, seed: int, device) -> dict:
    """``{"control": numbers, ...faults}`` of one seed."""
    import reference
    from reference import serve as ref_serve
    from reference import train as ref_train

    from harness import check, gen, weights
    from harness import fit as fit_driver

    cfg, tr = cell.config, cell.traffic
    ref = reference.build(cfg)
    if tr["driver"] == "serve":
        state = weights.make(ref, cfg, seed, device)
        pool = gen.serve_pool(seed, tr, device)
        ref = ref.to(device)
        ref.load_state_dict(state)
        low = reference.build(cfg, "fp8").to(device)
        low.load_state_dict(state)
        gaps = check.AnswerGap()
        with reference.exact_float32():
            for chunk in pool:
                gaps.add([ref_serve.probabilities(low, cfg, chunk)[0]],
                         *ref_serve.probabilities(ref, cfg, chunk))
        return {"control": {"logit_gap": gaps.logit_gap()}}
    inp = fit_driver.inputs(ref, cfg, tr, seed, device)
    want = {"set-up": fit_driver.reference_steps(ref, cfg, tr, inp, device)}
    starts = {"set-up": inp["state"]}
    detail, out = [], {}

    low = reference.build(cfg, "fp8")
    out["control"] = check.fit_numbers(
        {"set-up": fit_driver.reference_steps(low, cfg, tr, inp, device)},
        want, starts, detail)
    gaps = check.AnswerGap()
    gaps.add([fit_driver.reference_validation(low, cfg, inp, device)[0]],
             *fit_driver.reference_validation(ref, cfg, inp, device))
    out["control"]["val_logit_gap"] = gaps.logit_gap()
    saved = ref_train.example_losses
    ref_train.example_losses = _half_batch(saved)
    try:
        out["half_batch"] = check.fit_numbers(
            {"set-up": fit_driver.reference_steps(reference.build(cfg), cfg,
                                                  tr, inp, device)},
            want, starts, detail)
    finally:
        ref_train.example_losses = saved
    out["state_unchanged"] = {"delta_gap": 1.0}
    out["detail"] = detail
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    from harness import cells

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, torch.device("cuda", 0))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

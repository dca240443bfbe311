#!/usr/bin/env python3
"""Kernel B1 (the fused preprocess, ``ab_line_classifier_torch/csrc/
preprocess.cu``) of this checkout against another checkout's, on one
NVIDIA GPU, at the shapes the port's paths give it
(``chip_smoke.B1_SHAPES``: serving from 128x128 and 480x640 frames at
2048, deploy clips of 480x640 and 1080x1440, a training validation batch,
a batch-1 step).

Each checkout runs in a process of its own, in turns (other, this, this,
other, repeated ``--rounds`` times), and builds its kernel from its own
sources. For each shape it prints the kernel's device time (a CUDA graph
of its launches, per launch), its time per eager call (CUDA events: the
host's time where that is longer), the bytes bound and the share of it,
the plain version's time, ``F.interpolate``'s and a device copy's of as
many bytes, the max abs err against the plain version, and ptxas's
registers and spills of this checkout's kernel instances; at the end, per
shape, every device time of each checkout and whether each of this
checkout's runs was at least as fast as the other's run beside it. Run
from the root of a checkout, the other one unpacked into a directory that
``.gitignore`` lists::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_preprocess_ab.py build/parent [--rounds N]

Without an argument it times this checkout alone. The runs' JSON goes to
``build/preprocess_ab.json``.
"""

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree):
    """In a fresh process: build ``tree``'s kernel, time it, print JSON."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from ab_line_classifier_torch.ops import _build
    if not _build.CSRC_DIR.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_build.CSRC_DIR}, not {tree}'s")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build("preprocess")
    ptxas = [f"{name}: {line}" for name, line in
             smoke.ptxas_report(_build.build_log("preprocess"))]
    shapes = smoke.b1_shape_timings(
        torch.Generator(device="cuda").manual_seed(0))
    print(json.dumps({"tree": tree, "ptxas": ptxas, "shapes": shapes}))
    return 0


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if argv[:1] == ["--tree"]:
        return run_tree(argv[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    order = [REPO] if not argv else [argv[0], REPO, REPO, argv[0]] * rounds
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", tree], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = ("this" if os.path.abspath(tree) == REPO
                        else "other")
        runs.append(run)
        print(f"-- {run['label']} ({run['tree']})", flush=True)
        for line in run["ptxas"] if run["label"] == "this" else ():
            print(f"ptxas {line}")
        for label, t in run["shapes"].items():
            print(f"{label}: {t['ms']:.4f} ms a launch in a graph "
                  f"({t['eager_ms']:.4f} eager), bound {t['bound_ms']:.4f} "
                  f"({100 * t['share']:.1f}%), plain {t['plain_ms']:.4f}, "
                  f"F.interpolate {t['library_ms']:.4f}, copy "
                  f"{t.get('copy_ms', float('nan')):.4f}, max abs err "
                  f"{t['max_abs_err']}", flush=True)
    if argv:
        # Runs 2k and 2k + 1 are side by side: (other, this), (this, other).
        print("-- device ms per run, this against other")
        for label in runs[0]["shapes"]:
            ms = {side: [r["shapes"][label]["ms"] for r in runs
                         if r["label"] == side] for side in ("this", "other")}
            held = all(a <= b for a, b in zip(ms["this"], ms["other"]))
            print(f"{label}: this {', '.join(f'{t:.5f}' for t in ms['this'])}"
                  f"; other {', '.join(f'{t:.5f}' for t in ms['other'])}; "
                  f"this at least as fast in every pair: {held}", flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "preprocess_ab.json"), "w") as f:
        json.dump({"device": smi, "runs": runs}, f, indent=1)
    errs = [t["max_abs_err"] for r in runs for t in r["shapes"].values()]
    return 0 if max(errs) == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The benchmark of ``ab_line_classifier_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (a configuration under a traffic mix)
in this process, from the root of a checkout: set-up (the port's kernels
built into the checkout's ``build/`` on the first run, seeded weights and
traffic made on the device, the cell's shapes warmed and captured), then a
window of ``--seconds``; with ``--trace 1`` a profiled sub-window after it.
Then the reference checks what the timed path produced. The last line of
standard output is the result as one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key. Exits non-zero, printing no result, where CUDA or the
cell's cards are missing, where JAX or the JAX package is loaded, or on
any error."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ab_line_classifier_tpu")


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    Python's bytecode of the modules a run imports among them (where the
    installed packages keep none, a run would compile them all again)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", sub)
    sys.pycache_prefix = os.path.join(root, "build", "pycache")
    sys.dont_write_bytecode = False


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, outcome, traced: bool, device) -> dict:
    import torch

    from harness import check

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = m.read(outcome.view)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": outcome.e2e[m.name], "unit": m.unit}
                   for m in cell.end_to_end}
    correct, shown = check.judged(outcome.numbers, cell.limits)
    on_gpu = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": correct and outcome.failed == 0,
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": dev}
    red = outcome.view.trace
    if traced and red is not None:
        dev["busy_s"], dev["window_s"] = red.busy_s, red.window_s
        out["breakdown"] = {"device_ops": red.top_ops(),
                            "idle_gaps": red.idle_gaps()}
    if on_gpu:
        dev["power_limit_w"] = power_limit()
    out["checks"] = shown
    return out


def power_limit():
    import subprocess

    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(got.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    import torch

    from harness import cells

    cell = cells.load(args.workload, root=ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    driver = importlib.import_module(f"harness.{cell.traffic['driver']}")
    outcome = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    result = result_line(cell, outcome, bool(args.trace), device)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for note in outcome.notes:
        print(note, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

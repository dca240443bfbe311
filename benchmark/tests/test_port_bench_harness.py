"""The harness as data: traffic made from the seed alone, cells found by
name, and a configuration, a mix and a metric added as files."""

import ast
import json
import os
import shutil
import subprocess
import sys

import torch

from harness import cells, gen

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ab_line_classifier_tpu"}
BENCH = cells.BENCH_DIR
ROOT = cells.ROOT


def test_frames_are_the_seeds():
    t = {"chunk": 3, "pool_chunks": 2, "frame_hw": [20, 24],
         "brightness": [0.15, 1.0]}
    a, b = gen.serve_pool(2**33 + 7, t, "cpu"), gen.serve_pool(2**33 + 7, t,
                                                              "cpu")
    c = gen.serve_pool(2**33 + 8, t, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 20, 24, 3) and a[0].dtype == torch.uint8
    assert not torch.equal(a[0], a[1])


def test_fit_sets_are_the_seeds():
    t = {"frame_hw": [8, 8], "train_frames": 108, "val_split": 0.1,
         "positive_share": 0.5, "brightness": [0.15, 1.0]}
    one, two = gen.fit_sets(5, t, "cpu"), gen.fit_sets(5, t, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    other = gen.fit_sets(6, t, "cpu")
    assert not torch.equal(one[0], other[0])
    assert [x.shape[0] for x in one] == [108, 108, 12, 12]
    assert set(one[1].tolist()) <= {0, 1}


def test_weights_are_the_seeds():
    import reference
    from harness import weights

    cfg = json.load(open(f"{BENCH}/configs/mobilenetv2.json"))
    m = reference.build(cfg)
    a = weights.make(m, cfg, 11, "cpu")
    b = weights.make(m, cfg, 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv1.weight"],
                           weights.make(m, cfg, 12, "cpu")["Conv1.weight"])
    # statistics calibrated, not the defaults
    assert not torch.equal(a["bn_Conv1.running_var"],
                           torch.ones_like(a["bn_Conv1.running_var"]))


def test_every_cell_resolves():
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert set(cell.limits) >= {"logit_gap"} or set(cell.limits) >= {
            "loss_gap", "delta_gap", "val_logit_gap"}


def test_a_new_config_mix_and_metric_are_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    b = root / "benchmark"
    cfg = json.load(open(b / "configs" / "mobilenetv2.json"))
    cfg["name"] = "mobilenetv2-stand-in"
    json.dump(cfg, open(b / "configs" / "mobilenetv2-stand-in.json", "w"))
    mix = json.load(open(b / "traffic" / "serve-study.json"))
    mix.update(name="serve-small", chunk=16)
    json.dump(mix, open(b / "traffic" / "serve-small.json", "w"))
    (b / "metrics" / "frames.traced.py").write_text(
        "def read(view):\n    return float(view.frames)\n")
    json.dump({"logit_gap": 0.5}, open(b / "limits" / "stand-in.json", "w"))
    bench["configs"].append({"name": "mobilenetv2-stand-in",
                             "source": "https://arxiv.org/abs/1801.04381",
                             "file": "benchmark/configs/"
                                     "mobilenetv2-stand-in.json",
                             "reduced": [], "why": "a stand-in"})
    bench["workloads"].append({"name": "stand-in",
                               "config": "mobilenetv2-stand-in",
                               "traffic": "serve-small", "chips": 1,
                               "why": "a stand-in"})
    bench["per_layer"].append({"name": "frames.traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "serving engine",
                               "moves": "serve_frames_per_s"})
    bench["end_to_end"][0]["workloads"].append("stand-in")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    cell = cells.load("stand-in", root=str(root), bench_dir=str(b))
    assert cell.config["name"] == "mobilenetv2-stand-in"
    assert cell.traffic["chunk"] == 16
    names = [m.name for m in cell.per_layer]
    assert "frames.traced" in names and "mfu.serve" not in names
    reader = cell.per_layer[names.index("frames.traced")].read
    assert reader(type("V", (), {"frames": 7})()) == 7.0
    # A metric without "workloads" goes to every cell reporting its moves.
    other = cells.load("cutoffvgg16-serve-study", root=str(root),
                       bench_dir=str(b))
    assert "frames.traced" in [m.name for m in other.per_layer]
    fit = cells.load("cutoffvgg16-fit-cached", root=str(root),
                     bench_dir=str(b))
    assert "frames.traced" not in [m.name for m in fit.per_layer]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources(top):
    for d, _, files in os.walk(top):
        if "__pycache__" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_the_benchmark_runs_imports_jax():
    found = {(p, m) for p in _sources(BENCH) for m in _imports(p)
             if m.split(".", 1)[0] in FORBIDDEN}
    found |= {(p, m) for p in _sources(f"{ROOT}/ab_line_classifier_torch")
              for m in _imports(p) if m.split(".", 1)[0] in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(f"{BENCH}/reference"):
        for m in _imports(p):
            assert m.split(".", 1)[0] != "ab_line_classifier_torch", (p, m)
            assert m.split(".", 1)[0] not in ("harness",), (p, m)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run\n"
            "from harness import serve, fit, cells, check, trace, weights\n"
            "import ab_line_classifier_torch.predict.predict\n"
            "import ab_line_classifier_torch.train.loop\n"
            "import ab_line_classifier_torch.data.pipeline\n"
            "print(run.loaded_forbidden())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_it_exits_and_reports_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cutoffvgg16-serve-study", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_it_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mobilenetv2-serve-study", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

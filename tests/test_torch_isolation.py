"""PyTorch port, isolation: the port imports no JAX and nothing of the JAX
package, and its modules import only torch and numpy (plus the standard
library) when they are imported, so it runs where JAX, pandas, PIL,
sklearn, PyYAML, h5py, protobuf (``google.protobuf``), matplotlib and cv2
are not installed.
"""

import os
import subprocess
import sys

from conftest import REPO_ROOT, cli_env

PORT = "ab_line_classifier_torch"
PORT_DIR = os.path.join(REPO_ROOT, PORT)

_PROBE = r"""
import importlib, pkgutil, sys
import {pkg}
names = [m.name for m in pkgutil.walk_packages({pkg}.__path__, "{pkg}.")]
for name in names:
    importlib.import_module(name)
roots = {{m.split(".")[0] for m in sys.modules}}
# protobuf by its package: a namespace .pth may load "google" at startup.
roots |= {{m for m in sys.modules if m.startswith("google.protobuf")}}
print(len(names))
print(" ".join(sorted(roots)))
"""


def test_port_imports_no_jax_and_only_torch_numpy():
    r = subprocess.run([sys.executable, "-c", _PROBE.format(pkg=PORT)],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO_ROOT, env=cli_env())
    assert r.returncode == 0, r.stderr[-2000:]
    n_modules, roots = r.stdout.split("\n")[:2]
    assert int(n_modules) >= 15
    loaded = set(roots.split())
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax",
                 "ab_line_classifier_tpu", "pandas", "PIL", "sklearn",
                 "yaml", "h5py", "google.protobuf", "matplotlib", "cv2"}
    assert not loaded & forbidden, sorted(loaded & forbidden)


def test_port_sources_never_name_the_jax_package():
    hits = []
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if "ab_line_classifier_tpu" in line or any(
                            f"import {m}" in line or f"from {m}" in line
                            for m in ("jax", "flax", "optax", "orbax")):
                        hits.append(f"{os.path.relpath(path, REPO_ROOT)}:{i}")
    assert not hits, hits


def test_trial_parallel_modules_are_covered():
    """The trial-parallel modules are among the modules the probe above
    imports, and alone they load no JAX, pandas or the JAX package."""
    probe = (
        "import pkgutil, sys, ab_line_classifier_torch as p\n"
        "names = {m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ab_line_classifier_torch.')}\n"
        "print(sorted(n for n in names if 'parallel' in n))\n"
        "import ab_line_classifier_torch.parallel.trial_parallel\n"
        "import ab_line_classifier_torch.train.experiment\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, cwd=REPO_ROOT, env=cli_env())
    assert r.returncode == 0, r.stderr[-2000:]
    listed, roots = r.stdout.splitlines()[:2]
    assert "ab_line_classifier_torch.parallel.trial_parallel" in listed
    assert not {"jax", "pandas", "ab_line_classifier_tpu"} & set(
        eval(roots))


def test_raw_clip_modules_are_covered():
    """The raw-clip path's modules (auto-masking, the U-Net, morphology,
    video, deploy serving, the clip-rule experiments) are among the
    modules the probe above imports, and alone they load no JAX, pandas,
    cv2, h5py, matplotlib or the JAX package."""
    modules = ("data.auto_masking", "data.video", "models.unet",
               "ops.morphology", "predict.deploy", "predict.experiments")
    probe = (
        "import pkgutil, sys, importlib, ab_line_classifier_torch as p\n"
        "names = {m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ab_line_classifier_torch.')}\n"
        f"wanted = {['ab_line_classifier_torch.' + m for m in modules]}\n"
        "print(sorted(set(wanted) - names))\n"
        "for m in wanted:\n"
        "    importlib.import_module(m)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, cwd=REPO_ROOT, env=cli_env())
    assert r.returncode == 0, r.stderr[-2000:]
    missing, roots = r.stdout.splitlines()[:2]
    assert eval(missing) == []
    assert not {"jax", "pandas", "cv2", "h5py", "matplotlib",
                "ab_line_classifier_tpu"} & set(eval(roots))


def test_attribution_export_and_dataset_modules_are_covered():
    """Attribution, the ONNX exporter and its evaluator, the export CLI and
    the dataset-creation modules are among the modules the probe above
    imports, and alone they load no JAX, pandas, PIL, cv2, protobuf, mysql
    or the JAX package."""
    modules = ("predict.attribution", "utils.onnx_eval",
               "models.onnx_export", "export", "data.synthetic",
               "data.dataset_creator", "data.ab_line_dataset_creator",
               "data.real_time")
    probe = (
        "import pkgutil, sys, importlib, ab_line_classifier_torch as p\n"
        "names = {m.name for m in pkgutil.walk_packages(p.__path__, "
        "'ab_line_classifier_torch.')}\n"
        f"wanted = {['ab_line_classifier_torch.' + m for m in modules]}\n"
        "print(sorted(set(wanted) - names))\n"
        "for m in wanted:\n"
        "    importlib.import_module(m)\n"
        "roots = {m.split('.')[0] for m in sys.modules}\n"
        "roots |= {m for m in sys.modules if m.startswith('google.protobuf')}"
        "\n"
        "print(sorted(roots))\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, cwd=REPO_ROOT, env=cli_env())
    assert r.returncode == 0, r.stderr[-2000:]
    missing, roots = r.stdout.splitlines()[:2]
    assert eval(missing) == []
    assert not {"jax", "pandas", "PIL", "cv2", "mysql", "google.protobuf",
                "ab_line_classifier_tpu"} & set(eval(roots))

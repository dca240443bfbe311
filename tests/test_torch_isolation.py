"""PyTorch port, isolation: the port imports no JAX and nothing of the JAX
package, and its modules import only torch and numpy (plus the standard
library) when they are imported, so it runs where JAX, pandas, PIL,
sklearn, PyYAML, h5py, protobuf (``google.protobuf``) and matplotlib
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
                 "yaml", "h5py", "google.protobuf", "matplotlib"}
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

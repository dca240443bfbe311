"""PyTorch port, console scripts: ``pyproject.toml`` names an
``ablc-torch-*`` script beside each of the JAX package's ``ablc-*`` ones,
and each resolves to a callable ``main`` of the port whose import loads no
JAX and nothing of the JAX package.
"""

import os
import subprocess
import sys
import tomllib

import pytest

from conftest import REPO_ROOT, cli_env

SCRIPTS = ("train", "predict", "explain", "export", "automask")

_PROBE = r"""
import importlib, sys
module, attr = sys.argv[1].split(":")
fn = getattr(importlib.import_module(module), attr)
assert callable(fn), fn
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _scripts():
    with open(os.path.join(REPO_ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_every_jax_script_has_a_port_script():
    scripts = _scripts()
    assert sorted(k for k in scripts if k.startswith("ablc-torch-")) == \
        sorted(f"ablc-torch-{s}" for s in SCRIPTS)
    for name in SCRIPTS:
        jax_target = scripts[f"ablc-{name}"]
        port_target = scripts[f"ablc-torch-{name}"]
        assert jax_target.startswith("ab_line_classifier_tpu.")
        assert port_target == jax_target.replace(
            "ab_line_classifier_tpu.", "ab_line_classifier_torch.", 1)


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_script_resolves_without_jax(name):
    target = _scripts()[f"ablc-torch-{name}"]
    assert target.startswith("ab_line_classifier_torch.")
    r = subprocess.run([sys.executable, "-c", _PROBE, target],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO_ROOT, env=cli_env())
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(r.stdout.split())
    assert "ab_line_classifier_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "orbax",
                         "ab_line_classifier_tpu"}, sorted(loaded)

#!/usr/bin/env python3
"""Convert a JAX package checkpoint (an Orbax ``state/`` directory and its
``meta.json``) into a port checkpoint (``state.pt`` and the same
``meta.json``) that ``ab_line_classifier_torch`` serves::

    python scripts/orbax_to_torch.py <jax_model_dir> <port_model_dir>

It reads with the JAX package (JAX, flax and orbax must be installed, so it
runs on a host with the JAX package, not on the card's) and writes through
the port's weight bridge (``utils/jax_params.py``) and checkpoint module.
Zoo checkpoints and U-Net checkpoints both convert: a ``meta.json`` that
names no zoo model (a U-Net's) is restored without a target tree, as the
JAX package's ``load_model`` does. ``<jax_model_dir>`` may also be a
directory of checkpoints (the newest is taken) or ``.../latest``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def convert(jax_model_dir: str, port_model_dir: str) -> str:
    """Write the port checkpoint of ``jax_model_dir`` into
    ``port_model_dir``; returns its absolute path."""
    import jax

    from ab_line_classifier_tpu.utils import checkpoint as jax_ckpt
    from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
    from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

    variables, meta = jax_ckpt.load_model(jax_model_dir)
    variables = jax.tree.map(np.asarray, dict(variables))
    return torch_ckpt.save_model(port_model_dir,
                                 state_dict_from_flax(variables), meta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jax_model_dir")
    ap.add_argument("port_model_dir")
    args = ap.parse_args(argv)
    print(convert(args.jax_model_dir, args.port_model_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())

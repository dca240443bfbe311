"""PyTorch port, multi-process execution (``parallel/multihost.py``): two
rank processes (gloo on the CPU, asked for with ``device="cpu"``; one
subprocess each, one deadline for the pair) start a process group and
run one data-parallel cnn0 step (dropout and batch norms on) over a
``(1, 2)`` mesh and one trial-parallel epoch over ``(2, 1)``; the resume
file written on rank 0 alone reaches both. Held against one process of the port, as the JAX
package's ``tests/test_multihost.py`` holds its pair: within 1e-5
relative and 1e-6 absolute (the two-rank sums add in another order).
Then ``dryrun_multichip(4)``, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, runs end to end.
"""

import os

import numpy as np

from ab_line_classifier_torch.parallel.multihost import (
    dryrun_multichip, one_epoch_trial_parallel, one_step_params,
    spawn_dryrun_pair)


def test_two_process_step_matches_single_process(tmp_path):
    out = str(tmp_path / "mh_params.npz")
    multi = spawn_dryrun_pair(out, timeout=300, device="cpu")
    assert os.path.isfile(out)
    multi_leaves = [multi[k] for k in multi.files if k != "trial_val_loss"]
    single_leaves = one_step_params(None, "cpu")
    assert len(multi_leaves) == len(single_leaves)
    for m, s in zip(multi_leaves, single_leaves):
        np.testing.assert_allclose(m, s, rtol=1e-5, atol=1e-6)
    single_val = one_epoch_trial_parallel(None, 2, "cpu")
    assert multi["trial_val_loss"].shape == single_val.shape == (2,)
    np.testing.assert_allclose(multi["trial_val_loss"], single_val,
                               rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_four_ranks(capsys):
    dryrun_multichip(4, device="cpu", timeout=300)
    out = capsys.readouterr().out
    assert "multihost parity ok" in out
    assert "dryrun_multichip(4) OK" in out

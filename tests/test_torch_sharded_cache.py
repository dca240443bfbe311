"""PyTorch port, the frame cache split over the mesh's data axis
(``data/pipeline.py``: ``shard_frames_over_data``, ``sharded_gather``,
``ShardedDeviceCachedDataset``, ``maybe_device_cache(mesh=)``): the five
cases of ``tests/test_sharded_cache.py`` on 4 gloo ranks on the CPU
(``tests/torch_ranks.py``; the JAX package runs 8 virtual devices).

Every comparison is bit for bit: one rank supplies each row of a gathered
batch and the others add zeros, in uint8, so the gather equals the
replicated cache's and so do the fits built on it.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 1e-4, "NODES_DENSE0": 8,
      "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
      "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}
N = 58  # 4 data ranks: shards of 15, the last padded by 2 zero rows


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(9)
    frames = rng.randint(0, 256, (N, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 2, N).astype(np.int32)
    train_idx = [np.arange(0, 30), np.arange(20, 50)]
    val_idx = [np.arange(50, 58), np.arange(0, 9)]
    return {"frames": frames, "labels": labels, "hp": HP,
            "train_idx": train_idx, "val_idx": val_idx,
            "cls_w": np.array([[0.7, 1.6], [1.2, 0.85]], np.float32)}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return run_ranks("sharded_cache", 4, data,
                     str(tmp_path_factory.mktemp("sharded")))


def test_frames_actually_shard(ranks, data):
    """Rank 0 holds rows [0, 15) of the 58, as [S, H, W, 3] with S =
    ceil(58 / 4): a quarter of the frames, not all of them."""
    shape, local = ranks["shard"]
    assert shape == (15, 32, 32, 3)
    np.testing.assert_array_equal(local.numpy(), data["frames"][:15])


def test_batches_match_replicated(ranks):
    """Unshuffled and shuffled epochs: every batch's uint8 images (the
    all-reduce adds in uint8), labels and mask equal the replicated
    cache's."""
    assert len(ranks["batches_equal"]) == 2 * 8
    assert all(ranks["batches_equal"])


def test_training_bit_identical_to_replicated(ranks):
    (v_rep, h_rep), (v_sh, h_sh) = ranks["fits"]
    assert h_rep == h_sh
    for k in v_rep:
        assert torch.equal(v_rep[k], v_sh[k]), k


def test_trial_parallel_sharded_frames_bit_identical(ranks):
    (best_rep, hist_rep), (best_sh, hist_sh) = ranks["trial_fits"]
    for hr, hs in zip(hist_rep, hist_sh):
        np.testing.assert_array_equal(hr["train_loss"], hs["train_loss"])
        np.testing.assert_array_equal(hr["val_loss"], hs["val_loss"])
    for part in ("params", "buffers"):
        for k in best_rep[part]:
            assert torch.equal(best_rep[part][k], best_sh[part][k]), k


def test_auto_cache_tiers(ranks):
    """Replicated where one device's budget fits, split where only the
    data axis's 4 budgets do (forced caching too), streamed otherwise;
    no mesh, no split tier."""
    assert ranks["tiers"] == {
        "fits": "DeviceCachedDataset",
        "aggregate": "ShardedDeviceCachedDataset",
        "none": "FrameArrays",
        "forced": "ShardedDeviceCachedDataset",
        "no_mesh": "FrameArrays"}

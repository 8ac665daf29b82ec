"""The port's multi-process wiring (``pnpinversion_tpu_torch.parallel.multihost``)
on the CPU: the item partition and the metric reduction against the JAX
package's, two gloo ranks on the loopback (shard, reduce, bucketed
all_reduce of strided views, the gather of every rank's blocks), the local
launcher, and the one-process rules of ``initialize``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import WORKER, run_ranks
from pnpinversion_tpu.parallel import multihost as jmh
from pnpinversion_tpu_torch.parallel import multihost as mh

ITEMS = 7


@pytest.mark.parametrize("n,world", [(7, 2), (5, 2), (8, 4), (3, 4), (1, 1), (0, 3)])
def test_process_shard_matches_jax(n, world):
    items = [f"item{i}" for i in range(n)]
    shards = [mh.process_shard(items, r, world) for r in range(world)]
    assert shards == [jmh.process_shard(items, r, world) for r in range(world)]
    assert sorted(x for s in shards for x in s) == sorted(items)


def test_allreduce_metrics_without_a_group_is_jax_formula():
    assert not torch.distributed.is_initialized()
    sums = np.array([10.0, 20.0, 3.5], np.float32)
    for count in (4, 1, 0):
        np.testing.assert_array_equal(mh.allreduce_metrics(sums, count),
                                      jmh.allreduce_metrics(sums, count))


def _check_shard_results(results, world):
    shards = [set(r["shard"]) for r in results]
    assert set.union(*shards) == set(range(ITEMS)) and sum(map(len, shards)) == ITEMS
    want = [sum(range(ITEMS)) / ITEMS, sum(x * x for x in range(ITEMS)) / ITEMS]
    for r in results:
        np.testing.assert_allclose(r["mean"], want, rtol=1e-6)
    # each tensor summed over the ranks, the strided view written back
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    scale = sum(range(1, world + 1))
    for r in results:
        np.testing.assert_array_equal(r["reduced"][0], (base * scale)[:, 1:3])
        assert r["reduced"][1] == [float(sum(range(world)))] * 5
        assert r["reduced"][2] == [[float(sum(10 ** k for k in range(world)))] * 2] * 2
        assert r["collectives"] == 3  # 24-byte buckets: the view, the 5, the 2x2
        # every rank's block, gathered: rank r's columns / entries are 10 (r + 1)
        want = np.repeat(np.repeat(10.0 * np.arange(1, world + 1), 4 // world)[None], 3, 0)
        np.testing.assert_array_equal(r["gathered"][0], want)
        np.testing.assert_array_equal(r["gathered"][1], np.repeat(10.0 * np.arange(1, world + 1),
                                                                  6 // world))
        assert r["gathers"] == 2 * world  # 48-byte buckets: each tensor alone, a broadcast a rank


def test_two_ranks_shard_reduce_and_all_reduce(tmp_path):
    results = run_ranks("shard", {"items": ITEMS}, str(tmp_path))
    assert [r["shard"] for r in results] == [mh.process_shard(list(range(ITEMS)), r, 2)
                                             for r in range(2)]
    _check_shard_results(results, 2)
    # the rest of each rank's base is its own: only the view was reduced
    assert results[1]["base"][0][0] == 0.0 and results[1]["base"][0][3] == 6.0


def test_launch_local_starts_the_ranks(tmp_path):
    """``launch_local`` spawns two processes that join one group through a
    free loopback port and run the module's ``main`` with their rank flags."""
    cfg = tmp_path / "shard.json"
    cfg.write_text(json.dumps({"items": ITEMS, "out": str(tmp_path)}))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, WORKER, "launch", str(cfg)], env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    _check_shard_results(results, 2)


def test_initialize_one_process_rules():
    assert not mh.initialize(num_processes=1)  # no group, nothing to end
    assert not mh.initialize()
    assert (mh.rank(), mh.world()) == (0, 1)
    with pytest.raises(ValueError, match="process_id"):
        mh.initialize(num_processes=2)
    with pytest.raises(ValueError, match="backend"):
        mh.initialize(num_processes=1, backend="mpi")
    assert mh.rank_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.rank_device(None, 0)
    # a named backend makes a group of one, so the collectives run
    assert mh.initialize(num_processes=1, backend="gloo")
    try:
        assert (mh.rank(), mh.world()) == (0, 1)
        assert not mh.initialize(num_processes=1, process_id=0)  # already a member
        with pytest.raises(RuntimeError, match="rank 0 of 1"):
            mh.initialize("127.0.0.1:1", num_processes=2, process_id=1)
        np.testing.assert_allclose(mh.allreduce_metrics(np.array([6.0, 3.0]), 3), [2.0, 1.0])
        t = torch.arange(6.0).reshape(2, 3)
        assert mh.all_reduce_([t.T, torch.ones(4)], bucket_bytes=16) == 2
        np.testing.assert_array_equal(t.numpy(), np.arange(6.0).reshape(2, 3))
        assert mh.all_gather_blocks_([t], [1]) == 1  # one rank: its block is the tensor
        np.testing.assert_array_equal(t.numpy(), np.arange(6.0).reshape(2, 3))
        assert mh.block(t, 1, 0, 1) is not None and mh.block(t, None, 0, 2) is t
    finally:
        mh.shutdown()
    assert not torch.distributed.is_initialized()

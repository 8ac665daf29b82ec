"""``directinversion+pix2pix-zero`` through ``run_sweep_sharded --tp 2`` on the
CPU at TINY, f32: two gloo ranks against one process and the JAX runner's
(dp = 1, tp = 2) sweep (``tests/_torch_tp_family.py``), the cross-attention
guidance gradients taken on every rank, the captions from ``--caption_file``
(BLIP runs only where its weights are given), the posterior noise and the
autocorrelation rolls the values JAX draws (one table per edit, the same on
both ranks). pix2pix-zero takes no host decision: the ranks' records hold
their panels' digests."""
import pytest

import _torch_tp_family as fam

METHODS = ("directinversion+pix2pix-zero",)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return fam.run_family(str(tmp_path_factory.mktemp("tp")), {m: "sd14" for m in METHODS},
                          ("p2z",))


@pytest.mark.parametrize("method", METHODS)
def test_tp_sweep_writes_each_strip_once_and_counts_each_image_once(run, method):
    fam.check_written_once(run, method)


@pytest.mark.parametrize("method", METHODS)
def test_tp_sweep_matches_one_process(run, method):
    fam.check_one_process(run, method)


@pytest.mark.parametrize("method", METHODS)
def test_tp_sweep_matches_jax(run, method):
    fam.check_jax(run, method)


@pytest.mark.parametrize("method", METHODS)
def test_ranks_agree(run, method):
    assert fam.rank_records(run, method)["decisions"] == []

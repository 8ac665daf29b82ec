"""The instruction editors (``instruct-pix2pix``, ``instruct-diffusion``: the
8-channel UNet) and ``blended-latent-diffusion`` (a TINY SD2.1: 16-dim heads,
a GELU text tower, its 1x1 ``proj_in``/``proj_out``) through
``run_sweep_sharded --tp 2`` on the CPU at TINY, f32: two gloo ranks against
one process and the JAX runner's (dp = 1, tp = 2) sweep
(``tests/_torch_tp_family.py``; the port's noise is the values JAX draws).
Neither family takes a host decision: the ranks' records hold their panels'
digests."""
import pytest

import _torch_tp_family as fam

METHODS = {"instruct-pix2pix": "ip2p", "instruct-diffusion": "ip2p",
           "blended-latent-diffusion": "sd21"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return fam.run_family(str(tmp_path_factory.mktemp("tp")), METHODS, ("instruct", "bld"))


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

"""``null-text-inversion+p2p`` through ``run_sweep_sharded --tp 2`` on the CPU at
TINY, f32: two gloo ranks against one process and the JAX runner's (dp = 1,
tp = 2) sweep (``tests/_torch_tp_family.py``), the uncond embedding
optimised on every rank through the backward. Its inner Adam loop (10
steps, the reference's) stops once each image's loss falls below the
threshold: here 0.56 in both packages (TINY's losses start near 0.7), so the
stop is taken at both DDIM steps, before the loop's end. The ranks must take
it at the same inner step (``agreement.decision``) and hold the same
panels. Null-latent shares the stop and the check:
``test_torch_tp_null_latent.py`` (a file of its own: one JAX program of the
UNet's gradient a file)."""
import pytest

import _torch_tp_family as fam

METHODS = ("null-text-inversion+p2p",)
EPSILON = 0.56  # between the inner losses at the steps where the stops fall
INNER = 10  # the reference's inner steps, the JAX class's


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return fam.run_family(str(tmp_path_factory.mktemp("tp")), {m: "sd14" for m in METHODS},
                          epsilon=EPSILON)


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
    decisions = fam.rank_records(run, method)["decisions"]
    steps = [n for kind, n in decisions if kind == "uncond_inner_steps"]
    assert len(steps) == len(decisions) == fam.STEPS  # one decision an outer step
    assert all(1 <= n <= INNER for n in steps) and min(steps) < INNER  # the stop taken
    assert decisions == run[method]["one_run"]["record"]["decisions"]

"""``stylediffusion+p2p`` through ``run_sweep_sharded --tp 2`` on the CPU at
TINY, f32: two gloo ranks against one process and the JAX runner's (dp = 1,
tp = 2) sweep (``tests/_torch_tp_family.py``; the CLIP tower, split over the
group too, and the networks' start are JAX's). Each rank trains the
networks (replicated, not split) through the split UNet's backward; the
inner loops take at most ceil(INNER e^(-0.1 i)) Adam steps and stop once
the loss falls below the threshold, here 3.0 in both packages (TINY's
losses start above it), so the stop is taken at both DDIM steps. The ranks
must stop at the same inner step and hold the same panels."""
import pytest

import _torch_tp_family as fam

METHODS = ("stylediffusion+p2p",)
INNER = 4  # --num_inner_steps (the JAX runner's STYLEDIFFUSION_INNER_STEPS)
EPSILON = 3.0  # the stops fall at the same steps from 2.0 to 5.0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return fam.run_family(str(tmp_path_factory.mktemp("tp")), {m: "sd14" for m in METHODS},
                          ("stylediffusion",), inner=INNER, epsilon=EPSILON)


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
    steps = [n for kind, n in decisions if kind == "mapper_inner_steps"]
    assert len(steps) == len(decisions) == fam.STEPS  # one decision an outer step
    assert all(1 <= n <= INNER for n in steps) and min(steps) < INNER  # the stop taken
    assert decisions == run[method]["one_run"]["record"]["decisions"]

"""``parallel/agreement.py``, the record each rank of a tensor-parallel group
keeps of its host decisions and its results: nothing is kept outside
``recording()``; the decisions, losses and digests keep their order; a
nested record leaves the outer one as it was; a digest tells arrays apart by
their bytes, shape and dtype. And the inner loops that stop on a loss note
their losses and their steps: null-text's at TINY (torch only) takes one
step an outer step when the threshold is above every loss, all of them when
it is below, and notes each step's losses, one per image."""
import numpy as np
import pytest
import torch

from _torch_parity import pipeline_params, tiny_configs, torch_pipeline
from pnpinversion_tpu_torch.inversion.ddim_inversion import (
    ddim_invert_loop,
    null_text_optimization,
)
from pnpinversion_tpu_torch.parallel import agreement

torch.set_num_threads(2)


def test_nothing_is_kept_outside_a_record():
    agreement.decision("x", 3)
    agreement.digest("y", np.zeros(2))
    agreement.losses("z", torch.ones(2))
    with agreement.recording() as record:
        pass
    assert record == {"decisions": [], "losses": [], "digests": []}


def test_records_keep_their_order_and_nest():
    a = np.arange(6, dtype=np.uint8)
    with agreement.recording() as outer:
        agreement.decision("steps", 2)
        with agreement.recording() as inner:
            agreement.decision("steps", 5)
        agreement.digest("panels", a)
        agreement.decision("steps", np.int64(1))
        agreement.losses("loss", torch.tensor([0.5, 0.25]))
    assert inner == {"decisions": [["steps", 5]], "losses": [], "digests": []}
    assert outer["decisions"] == [["steps", 2], ["steps", 1]]
    assert outer["losses"] == [["loss", [0.5, 0.25]]]
    assert [k for k, _ in outer["digests"]] == ["panels"]


def test_digest_sees_bytes_shape_and_dtype():
    def one(*arrays):
        with agreement.recording() as record:
            agreement.digest("d", *arrays)
        return record["digests"][0][1]

    a = np.arange(6, dtype=np.uint8)
    assert one(a) == one(a.copy())
    assert len({one(a), one(a.reshape(2, 3)), one(a.astype(np.int8)), one(a[::-1]),
                one(a, a)}) == 5


@pytest.mark.parametrize("epsilon, want", [(1e3, 1), (0.0, 3)])
def test_null_text_notes_its_inner_steps(epsilon, want):
    jcfg, tcfg = tiny_configs()
    pipe = torch_pipeline(pipeline_params(jcfg, seed=3), 2, tcfg)
    rng = np.random.RandomState(4)
    latent = torch.from_numpy(rng.randn(2, 1, 8, 8, 4).astype(np.float32))
    cond, uncond = (torch.from_numpy(rng.randn(2, 1, 77, 32).astype(np.float32))
                    for _ in range(2))
    with torch.no_grad():
        traj = ddim_invert_loop(pipe.unet, pipe.schedule, latent, cond)
    with agreement.recording() as record:
        null_text_optimization(pipe.unet, pipe.schedule, traj, uncond, cond, 7.5,
                               num_inner_steps=3, epsilon=epsilon)
    assert record["decisions"] == [["uncond_inner_steps", want]] * 2
    losses = record["losses"]
    assert [kind for kind, _ in losses] == ["uncond_loss"] * (2 * want)
    assert all(len(v) == 2 and all(x > 0 for x in v) for _, v in losses)

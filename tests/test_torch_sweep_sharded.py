"""The port's multi-process sweep (``runners.run_sweep_sharded``) on the CPU at
TINY, as two gloo ranks on the loopback: five items (an odd count, so rank 0
pads its last chunk) written once each, each rank's strips byte for byte
those of a one-process ``runners.run_sweep`` over that rank's slice, the
totals reduced on both ranks, and a second run in which rank 1 has nothing
pending and still reaches the reduction. The ranks import no JAX."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from _torch_mp_worker import tiny_create
from _torch_parity import run_ranks
from pnpinversion_tpu_torch.data.pie_bench import mask_encode
from pnpinversion_tpu_torch.pipeline import SDPipeline

METHOD = "directinversion+p2p"
N = 5
# two blend specs: the grouping by spec runs inside each rank's slice
PROMPTS = [("a cat sitting on a mat", "a dog sitting on a mat", "cat dog"),
           ("a red car on the road", "a blue car on the road", "red blue"),
           ("a cat sitting on a mat", "a cat sitting on a red mat", "")]


def _dataset(root: str, keys) -> str:
    """A PIE-Bench mapping of seeded PNG inputs (lossless strips out) for
    the items ``keys`` of the N."""
    rng = np.random.RandomState(0)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "annotation_images", "0_random"), exist_ok=True)
    mapping = {}
    for i in range(N):
        img = (rng.rand(24, 24, 3) * 255).astype(np.uint8)
        if i not in keys:
            continue
        rel = f"0_random/{i:06d}.png"
        Image.fromarray(img).save(os.path.join(data, "annotation_images", rel))
        mask = np.zeros((512, 512), np.uint8)
        mask[128:384, 96:320] = 1
        src, tar, blend = PROMPTS[i % len(PROMPTS)]
        mapping[f"{i:06d}"] = {"image_path": rel, "original_prompt": src, "editing_prompt": tar,
                               "editing_instruction": "", "editing_type_id": "0",
                               "blended_word": blend, "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


def _argv(data: str, out: str, log: str) -> list:
    return ["--method", METHOD, "--data_path", data, "--output_path", out,
            "--num_ddim_steps", "2", "--batch_per_device", "2", "--run_log", log,
            "--device", "cpu"]


def _strips(out: str) -> dict:
    folder = os.path.join(out, METHOD, "annotation_images", "0_random")
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


def test_two_ranks_write_their_slices(tmp_path, monkeypatch):
    data = _dataset(str(tmp_path), range(N))
    out, log = str(tmp_path / "out"), str(tmp_path / "log.jsonl")
    rank0 = [os.path.join(out, METHOD, "annotation_images", "0_random", f"{i:06d}.png")
             for i in range(0, N, 2)]
    results = run_ranks("sweep", {"argv": _argv(data, out, log), "again": True,
                                  "delete": rank0}, str(tmp_path / "ranks"))
    first = [r["runs"][0] for r in results]
    assert first == [{"images": 3, "images_total": 5, "batch": 2, "rank": 0, "world": 2},
                     {"images": 2, "images_total": 5, "batch": 2, "rank": 1, "world": 2}]
    # the rerun: rank 0 re-edits its three, rank 1 skips both and still reduces
    second = [r["runs"][1] for r in results]
    assert second == [{"images": 3, "images_total": 3, "batch": 2, "rank": 0, "world": 2},
                      {"images": 0, "images_total": 3, "batch": 0, "rank": 1, "world": 2}]
    events = [json.loads(line) for line in open(log)]
    done = [e["key"] for e in events if e["event"] == "image_done"]
    assert sorted(done) == sorted([f"{i:06d}" for i in range(N)] + [f"{i:06d}" for i in
                                                                     range(0, N, 2)])
    assert sorted(e["key"] for e in events if e["event"] == "image_skip") == ["000001", "000003"]
    assert sorted((e["process_index"], e["images_total"]) for e in events
                  if e["event"] == "sweep_done") == [(0, 3), (0, 5), (1, 3), (1, 5)]
    strips = _strips(out)
    assert sorted(strips) == [f"{i:06d}.png" for i in range(N)]

    # each rank's strips, byte for byte, a one-process run_sweep over its slice
    from pnpinversion_tpu_torch.runners import run_sweep

    monkeypatch.setattr(SDPipeline, "create", classmethod(tiny_create))
    for rank in range(2):
        keys = list(range(rank, N, 2))
        sliced = _dataset(str(tmp_path / f"slice{rank}"), keys)
        ref = str(tmp_path / f"ref{rank}")
        done = run_sweep.main(_argv(sliced, ref, str(tmp_path / f"ref{rank}.jsonl")))
        assert done == {"images": len(keys), "batch": 2}
        want = _strips(ref)
        assert sorted(want) == [f"{i:06d}.png" for i in keys]
        for name, raw in want.items():
            assert strips[name] == raw, (rank, name)


def test_tp_and_cuda_rules(tmp_path):
    """A ``--tp`` that does not divide the processes raises (one process on
    the CPU included; before starting any); no CUDA and no ``--device cpu``
    raises. The tp path itself: ``tests/test_torch_tensor_parallel.py``."""
    from pnpinversion_tpu_torch.runners import run_sweep_sharded

    with pytest.raises(ValueError, match="--tp 2 does not divide the 1 processes"):
        run_sweep_sharded.main(["--data_path", str(tmp_path), "--tp", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--tp 2 does not divide the 3 processes"):
        run_sweep_sharded.main(["--data_path", str(tmp_path), "--n_devices", "3", "--tp", "2",
                                "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep_sharded.main(["--data_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # before starting any process
        run_sweep_sharded.main(["--data_path", str(tmp_path), "--n_devices", "2"])

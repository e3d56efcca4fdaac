"""`python -m mvs_tpu_torch.cli train` with train.mesh_data=2 (CasMVSNet)
and with train.mesh_view=2 (MVSNet) as two CPU ranks (gloo, torchrun's
variables from parallel.launch_local) on the synthetic
DTU training layout of tests/test_torch_train_cli.py: an epoch of 3 steps
at global batch 2 with a val split and a checkpoint, then --resume for a
second epoch. Held against one process at the same global batch: the
first loss within rtol 1e-4 (mvs_tpu's own bound for its data-parallel
loss, tests/test_parallel.py), every later loss and the validation
metrics within 2e-3 (the f32 BatchNorm moments of two halves averaged
against the whole batch's move the loss by ~1e-5 at the first step, and
each SGD step carries that on; the float64 step is held to 1e-12 in
tests/test_torch_parallel.py), the shares of pixels past 2 / 4 / 8 mm
within 0.01; rank 0 alone writes the checkpoints, their index and the
scalars.
"""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from mvs_tpu_torch.cli import train
from mvs_tpu_torch.parallel import launch_local
from mvs_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_train_cli import _train_args

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from mvs_tpu_torch.utils.make_synthetic_dtu import generate

    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=2,
                    num_views=3, height=32, width=64, num_depth=16,
                    num_lights=2, tilt=(0.05, 0.02))


def _args(root, log_dir, *extra):
    """test_torch_train_cli's run at global batch 2, with SGD: Adam's
    normalised steps would carry the f32 rounding of the BatchNorm moments
    (two halves averaged against the whole batch's) into every parameter
    at the step size."""
    return ["data.batch_size=2" if a == "data.batch_size=3" else a
            for a in _train_args(root, log_dir, "train.optimizer=sgd",
                                 *extra)]


# The CLI with TensorBoard's import refused (the scalars go to JSONL
# only): it pulls in TensorFlow where that is installed, ~20 s a process.
CLI = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
       "from mvs_tpu_torch.cli.__main__ import main; main(sys.argv[1:])")


def _two_ranks(root, log_dir, *extra):
    argv = [sys.executable, "-c", CLI, "train", *_args(root, log_dir, *extra)]
    # Two threads a rank: the ranks share this host's cores.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    ranks = launch_local(argv, 2, timeout=150.0, cwd=ROOT, env=env)
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-3000:]}"
    return [out for _, out in ranks]


def _scalars(log_dir, key):
    return [x[key] for x in map(json.loads, (log_dir / "scalars.jsonl")
                                .read_text().splitlines()) if key in x]


# {mesh: (the model's arguments, the two ranks' mesh argument)}: CasMVSNet
# over two data ranks, MVSNet's source views over two view ranks (both
# ranks load every row of the global batch).
MESHES = {"data": ((), "train.mesh_data=2"),
          "view": (("model.name=mvsnet",), "train.mesh_view=2")}
EPOCHS = (("train.epochs=1",), ("train.epochs=2", "--resume"))


@pytest.fixture(scope="module")
def all_runs(root, tmp_path_factory):
    """For each of MESHES, the two-rank runs (each mesh on a thread of its
    own) beside the one-process runs."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    dirs = {m: [tmp_path_factory.mktemp(f"{m}_{n}") for n in ("two", "one")]
            for m in MESHES}
    outs = {m: [] for m in MESHES}
    threads = [threading.Thread(target=lambda m=m: outs[m].extend(
        _two_ranks(root, dirs[m][0], *MESHES[m][0], MESHES[m][1], *extra)
        for extra in EPOCHS)) for m in MESHES]
    for t in threads:
        t.start()
    try:
        want = {m: [train.main(_args(root, dirs[m][1], *MESHES[m][0],
                                     *extra)) for extra in EPOCHS]
                for m in MESHES}
    finally:
        for t in threads:
            t.join()
        mp.undo()
    for m in MESHES:
        assert len(outs[m]) == 2, m
    return {m: dict(two=dirs[m][0], outs=outs[m], want=want[m])
            for m in MESHES}


@pytest.fixture(scope="module")
def runs(all_runs):
    return all_runs["data"]


def _first_epoch_like_one_process(run, mesh_line):
    """The first epoch's two ranks: rank 0 alone reports, after the mesh
    line; every step's loss and the validation metrics as one process's."""
    two, (first, _), (want, _) = run["two"], run["outs"], run["want"]
    for r, out in enumerate(first):
        assert out.startswith(f"rank {r}/2: torch.distributed backend gloo "
                              f"on cpu"), out[:200]
    assert mesh_line in first[0]
    assert "epoch 0 step 3/3 loss" in first[0]
    assert "epoch 0 step" not in first[1]  # rank 0 alone reports
    assert want["step"] == 3
    losses = _scalars(two, "train/loss")
    np.testing.assert_allclose(losses[0], want["losses"][0], rtol=1e-4)
    np.testing.assert_allclose(losses[:3], want["losses"], rtol=2e-3)
    for k, v in want["val"].items():
        if k.startswith("thres"):  # shares of pixels: a pixel may flip
            np.testing.assert_allclose(_scalars(two, f"val/{k}")[0], v,
                                       atol=0.01)
        else:
            np.testing.assert_allclose(_scalars(two, f"val/{k}")[0], v,
                                       rtol=2e-3)


def _resumed_like_one_process(run):
    """Rank 0 alone checkpointed; every rank resumed from it and went on as
    one process does."""
    two, (_, second), (_, want) = run["two"], run["outs"], run["want"]
    assert "resumed at step 3 (epoch 1)" in second[0]
    ckpt = CheckpointManager(two / "ckpt")
    assert ckpt.steps() == [3, 6]
    assert sorted(p.name for p in (two / "ckpt").iterdir()) == [
        "metrics.json", "step_00000003.pt", "step_00000006.pt"]
    assert ckpt.restore("latest")["optimizer"]["count"] == 6
    np.testing.assert_allclose(_scalars(two, "train/loss")[3:],
                               want["losses"], rtol=2e-3)
    # One writer: each step logged once over the two runs.
    assert len(_scalars(two, "train/loss")) == 6


MESH_LINE = "mesh {{'data': {}, 'view': {}, 'depth': 1, 'space': 1}}: "


def test_two_ranks_train_the_global_batch(runs):
    _first_epoch_like_one_process(
        runs, MESH_LINE.format(2, 1) + "every source view on every rank")


def test_rank_zero_checkpoints_and_every_rank_resumes(runs):
    _resumed_like_one_process(runs)


def test_view_ranks_train_like_one_process(all_runs):
    """MVSNet with its source views over two view ranks, under the data=2
    run's limits; the CLI installed the view hook (each rank warps its
    own source view), which validation runs through in eval mode."""
    _first_epoch_like_one_process(
        all_runs["view"], MESH_LINE.format(1, 2)
        + "the source views split over the 'view' ranks")


def test_view_ranks_checkpoint_and_resume(all_runs):
    _resumed_like_one_process(all_runs["view"])

"""`python -m mvs_tpu_torch.cli train` end to end on the CPU, on a synthetic
DTU training layout written by the port's generator (2 scans x 3 views at
32x64, 2 lights): 2 steps with a val split and a checkpoint per epoch,
--resume, then `infer --step best | latest | N` from the checkpoints, a
state_dict written before the statistics had a count, BatchNorm
recalibration, MVSNet, CVP-MVSNet and AACVP-MVSNet (configs/cvp_train_dtu.yaml,
then `infer --config configs/cvp_eval_dtu.yaml --step latest`), and the
configs read without PyYAML.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mvs_tpu_torch.cli import infer, train
from mvs_tpu_torch.cli.__main__ import main as cli_main
from mvs_tpu_torch.io import read_pfm
from mvs_tpu_torch.io.dtu import DTUTrainDataset, collate_cascade
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.nn.blocks import BatchStats
from mvs_tpu_torch.train.checkpoint import CheckpointManager
from mvs_tpu_torch.train.tasks import CascadeTask, batch_to_device
from mvs_tpu_torch.utils.config import load_config, load_yaml_subset
from mvs_tpu_torch.utils.make_synthetic_dtu import generate

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

MODEL = ["model.ndepths=8,8,8", "data.num_views=3", "data.num_depth=16",
         "data.interval_scale=1.0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=2,
                    num_views=3, height=32, width=64, num_depth=16,
                    num_lights=2, tilt=(0.05, 0.02))


def _train_args(root, log_dir, *extra):
    return ["--device", "cpu", *MODEL, f"data.root={root}",
            f"data.train_list={root / 'lists' / 'train.txt'}",
            f"data.val_list={root / 'lists' / 'val.txt'}",
            "data.batch_size=3", "train.summary_every_steps=1",
            "train.warmup_steps=2", f"train.log_dir={log_dir}", *extra]


@pytest.fixture(scope="module")
def run(root, tmp_path_factory):
    """One epoch of 2 steps (1 scan x 2 lights x 3 refs at batch 3), then
    --resume for a second epoch."""
    log_dir = tmp_path_factory.mktemp("run")
    first = train.main(_train_args(root, log_dir, "train.epochs=1"))
    second = train.main(_train_args(root, log_dir, "train.epochs=2",
                                    "--resume"))
    return log_dir, first, second


def test_train_takes_steps_and_checkpoints(run):
    log_dir, first, second = run
    assert first["step"] == 2 and len(first["losses"]) == 2
    assert np.isfinite(first["losses"]).all()
    assert set(first["val"]) >= {"abs_depth_error", "thres2mm_error",
                                 "last_stage_loss", "loss"}
    ckpt = CheckpointManager(log_dir / "ckpt", best_metric="abs_depth_error")
    assert ckpt.steps() == [2, 4]
    saved = ckpt.restore(2)
    assert saved["metrics"]["abs_depth_error"] == pytest.approx(
        first["val"]["abs_depth_error"])
    assert saved["optimizer"]["count"] == 2
    lines = [json.loads(x) for x in (log_dir / "scalars.jsonl").read_text(
    ).splitlines()]
    assert [x["step"] for x in lines if "train/loss" in x] == [1, 2, 3, 4]
    assert any("val/abs_depth_error" in x for x in lines)


def test_resume_continues_from_the_latest_step(run, capsys):
    log_dir, first, second = run
    # The resumed run starts at step 2 and takes epoch 1's two steps only.
    assert second["step"] == 4 and len(second["losses"]) == 2
    ckpt = CheckpointManager(log_dir / "ckpt")
    latest = ckpt.restore("latest")
    assert latest["step"] == 4 and latest["optimizer"]["count"] == 4
    counts = {k: float(v) for k, v in latest["model"].items()
              if k.endswith("count")}
    assert set(counts.values()) == {4.0}  # 4 train-mode updates each


@pytest.mark.parametrize("step", ["best", "latest", "2"])
def test_infer_from_checkpoint_dir(run, root, tmp_path, step, capsys):
    log_dir = run[0]
    best = CheckpointManager(log_dir / "ckpt",
                             best_metric="abs_depth_error").best_step()
    want = {"best": best, "latest": 4, "2": 2}[step]
    result = infer.main([
        "--ckpt", str(log_dir / "ckpt"), "--step", step, "--out",
        str(tmp_path), "--device", "cpu", *MODEL,
        f"data.eval_root={root}", f"data.eval_list={root / 'lists' / 'val.txt'}",
        "data.max_h=32", "data.max_w=64", "data.batch_size=2"])
    assert result["step"] == want and result["maps"] == 3
    assert f"using checkpoint step {want}" in capsys.readouterr().out
    depth, _ = read_pfm(tmp_path / "scan2" / "depth_est" / "00000001.pfm")
    assert depth.shape == (32, 64) and np.isfinite(depth).all()


def test_infer_reads_a_state_dict_without_counts(root, tmp_path):
    """A .pt written before the statistics had a count (the port's
    inference-only checkpoints) still loads into `infer`."""
    state = CasMVSNet(ndepths=(8, 8, 8)).state_dict()
    path = tmp_path / "old.pt"
    torch.save({k: v for k, v in state.items() if not k.endswith("count")},
               path)
    result = infer.main([
        "--ckpt", str(path), "--out", str(tmp_path / "out"), "--device",
        "cpu", *MODEL, f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'val.txt'}", "data.max_h=32",
        "data.max_w=64"])
    assert result["maps"] == 3 and result["step"] is None


def test_train_refuses_what_is_not_ported(root, tmp_path, monkeypatch):
    # A mesh larger than the process group, over any axis (depth and
    # space sharding run over as many ranks:
    # tests/test_torch_volume_sharding.py).
    for axis in ("data", "depth", "space"):
        with pytest.raises(ValueError, match="needs 2 processes, have 1"):
            train.main(_train_args(root, tmp_path, f"train.mesh_{axis}=2"))
    # Point-MVSNet trains (2 steps, a val pass, a checkpoint that `infer`
    # loads, maps at half the images' resolution), in float32 only.
    point = ["model.name=point_mvsnet", "model.num_depth_coarse=16"]
    result = train.main(_train_args(root, tmp_path / "point", *point,
                                    "train.epochs=1"))
    assert result["step"] == 2 and np.isfinite(result["losses"]).all()
    assert {"coarse_loss", "flow2_loss", "lt1_interval"} <= set(
        result["val"])
    maps = infer.main([
        "--ckpt", result["ckpt_dir"], "--out", str(tmp_path / "out"),
        "--device", "cpu", *MODEL, *point, f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'val.txt'}", "data.max_h=32",
        "data.max_w=64"])
    assert maps["step"] == 2 and maps["maps"] == 3
    depth, _ = read_pfm(tmp_path / "out" / "scan2" / "depth_est" /
                        "00000001.pfm")
    assert depth.shape == (16, 32) and np.isfinite(depth).all()
    with pytest.raises(ValueError, match="float32 only"):
        train.main(_train_args(root, tmp_path, *point,
                               "model.compute_dtype=bfloat16"))
    with pytest.raises(NotImplementedError, match="lookahead"):
        train.main(_train_args(root, tmp_path, "train.optimizer=ranger"))
    # No silent fallback to the CPU: without --device the run is on the card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _train_args(root, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train", *args[2:]])


def test_train_mvsnet_then_infer(root, tmp_path, capsys):
    """`train model.name=mvsnet` (OHEM loss, RefineNet) takes MVSNetTask's
    steps on collate_mvsnet's batches, validates and checkpoints; `infer`
    reads its checkpoint and writes 1/4-resolution maps."""
    mvsnet = ["model.name=mvsnet", "model.refine=true"]
    result = train.main(_train_args(root, tmp_path / "run", *mvsnet,
                                    "train.loss=ohem", "train.epochs=1"))
    assert result["step"] == 2 and np.isfinite(result["losses"]).all()
    assert {"abs_depth_error", "loss"} <= set(result["val"])
    assert "last_stage_loss" not in result["val"]
    saved = CheckpointManager(result["ckpt_dir"]).restore("latest")
    assert "RefineNet_0.ConvBlock_3.Norm_0.count" in saved["model"]
    out = tmp_path / "out"
    res = infer.main(["--ckpt", result["ckpt_dir"], "--out", str(out),
                      "--device", "cpu", *MODEL, *mvsnet,
                      f"data.eval_root={root}",
                      f"data.eval_list={root / 'lists' / 'val.txt'}",
                      "data.max_h=32", "data.max_w=64"])
    assert res["step"] == 2 and res["maps"] == 3
    depth, _ = read_pfm(out / "scan2" / "depth_est" / "00000001.pfm")
    assert depth.shape == (8, 16) and np.isfinite(depth).all()


@pytest.mark.parametrize("name", ["cvp_mvsnet", "aacvp_mvsnet"])
def test_train_cvp_then_infer(root, tmp_path, capsys, monkeypatch, name):
    """`train --config configs/cvp_train_dtu.yaml model.name=<name>` (2
    levels, 16 coarse hypotheses at this size) takes PyramidTask's steps on
    collate_pyramid's batches, validates and checkpoints; every BatchNorm
    counts one update per level and step. `infer --config
    configs/cvp_eval_dtu.yaml --step latest` (5 levels, epipolar interval,
    bf16; the pyramid shares its modules over the levels, so the 2-level
    checkpoint loads) writes maps at the images' resolution."""
    result = train.main([
        "--config", str(CONFIGS / "cvp_train_dtu.yaml"), "--device", "cpu",
        f"model.name={name}", "model.coarse_depths=16", "data.num_depth=16",
        f"data.root={root}", f"data.train_list={root / 'lists' / 'train.txt'}",
        f"data.val_list={root / 'lists' / 'val.txt'}", "data.batch_size=3",
        "train.epochs=1", "train.summary_every_steps=1",
        f"train.log_dir={tmp_path / 'run'}"])
    assert result["step"] == 2 and np.isfinite(result["losses"]).all()
    assert {"abs_depth_error", "loss"} <= set(result["val"])
    saved = CheckpointManager(result["ckpt_dir"]).restore("latest")
    counts = {float(v) for k, v in saved["model"].items()
              if k.endswith("count")}
    assert counts == {4.0}  # 2 steps x 2 levels
    assert ("PyramidFeatureNet_0.AttentionConv_0.rel_h" in saved["model"]
            ) == (name == "aacvp_mvsnet")
    out = tmp_path / "out"
    res = infer.main([
        "--config", str(CONFIGS / "cvp_eval_dtu.yaml"), "--ckpt",
        result["ckpt_dir"], "--step", "latest", "--out", str(out),
        "--device", "cpu", f"model.name={name}", "model.coarse_depths=16",
        f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'val.txt'}", "data.num_views=3",
        "data.max_h=32", "data.max_w=64", "data.align=32"])
    assert res["step"] == 2 and res["maps"] == 3
    assert "using checkpoint step 2 (latest)" in capsys.readouterr().out
    depth, _ = read_pfm(out / "scan2" / "depth_est" / "00000001.pfm")
    assert depth.shape == (32, 64) and np.isfinite(depth).all()
    # Without --device the run is on the card: no silent CPU fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train", "--config", str(CONFIGS / "cvp_train_dtu.yaml"),
                  f"model.name={name}", f"data.root={root}",
                  f"data.train_list={root / 'lists' / 'train.txt'}"])


@pytest.mark.parametrize("path", sorted(CONFIGS.glob("*.yaml")),
                         ids=lambda p: p.name)
def test_yaml_subset_reads_the_configs_as_pyyaml(path):
    import yaml

    text = path.read_text()
    assert load_yaml_subset(text) == yaml.safe_load(text)


def test_train_config_loads_without_pyyaml(monkeypatch):
    """The card's machine has no PyYAML: `train --config` still reads it."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = load_config(CONFIGS / "cas_train_dtu.yaml", ["data.batch_size=4"])
    assert cfg.model.ndepths == (48, 32, 8)
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.lr_schedule == "10,12,14:2"
    assert cfg.train.warmup_steps == 500 and cfg.data.batch_size == 4


def test_bn_recalibration_takes_the_batch_moments(root):
    """train.bn_recal_batches: each BatchNorm ends with the equal-weight
    mean of the recalibration batches' moments and count 1, as the JAX
    CLI's recalibration from zero statistics reads back."""
    ds = DTUTrainDataset(root, ["scan1"], num_views=3, num_depth=16,
                         interval_scale=1.0)
    batch = collate_cascade([ds[0], ds[1]])
    model = CasMVSNet(ndepths=(8, 8, 8))
    task = CascadeTask(model)
    assert train.recalibrate_bn(task, [batch, batch], "cpu") == 2
    recal = {k: v.clone() for k, v in model.state_dict().items()}
    norms = [m for m in model.modules() if isinstance(m, BatchStats)]
    for m in norms:
        m.count.zero_()
    with torch.no_grad():
        task.forward(batch_to_device(batch, "cpu"))
    for k, v in model.state_dict().items():
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(recal[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        elif k.endswith("count"):
            assert float(recal[k]) == 1.0
    args = _train_args(root, root.parent / "recal", "train.epochs=1",
                       "train.bn_recal_batches=1")
    assert train.main(args)["step"] == 2

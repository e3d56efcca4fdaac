"""The port's visualization (mvs_tpu_torch.utils.vis), image logging, the
validation panel of `cli train` and its MVS_TPU_DEBUG_NANS guard, against
mvs_tpu on the CPU.

  * colorize_depth / colorize_error / depth_image_summary: the uint8
    arrays equal mvs_tpu's (same seeded depths, masks and ranges);
    save_depth_png writes that image (decoded by io.png);
  * _summary_triplet picks mvs_tpu's (est, gt, mask) for every task kind
    (MVSNet, CasMVSNet, CVP / AACVP, Point-MVSNet);
  * `cli train` (CasMVSNet, 2 steps on the port's synthetic DTU layout)
    writes the est | gt | error panel of its first validation batch as
    <log_dir>/images/val_depth_<step>.png;
  * with MVS_TPU_DEBUG_NANS=1 a batch whose image holds a NaN raises
    FloatingPointError naming the step, and anomaly detection is off
    again after the run.
"""

import numpy as np
import pytest
import torch

from mvs_tpu.cli import train as jax_train
from mvs_tpu.train import tasks as jax_tasks
from mvs_tpu.utils import vis as jax_vis
from mvs_tpu_torch.cli import train
from mvs_tpu_torch.io.dtu import DTUTrainDataset
from mvs_tpu_torch.io.png import read_png
from mvs_tpu_torch.train import tasks
from mvs_tpu_torch.utils import vis
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.meters import ScalarLogger


def _maps(seed, shape=(20, 24)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(400, 900, shape).astype(np.float32)
    est = (gt + rng.normal(0, 6, shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) > 0.3).astype(np.float32)
    gt[~(mask > 0.5)] = 0
    return est, gt, mask


@pytest.mark.parametrize("kwargs", [{}, {"d_min": 500.0, "d_max": 800.0},
                                    {"mask": True}])
def test_colorize_depth_matches_jax(kwargs):
    est, _, mask = _maps(0)
    est[3, 4] = 0.0
    if kwargs.get("mask"):
        kwargs = {"mask": mask}
    got = vis.colorize_depth(est, **kwargs)
    assert got.dtype == np.uint8 and got.shape == (20, 24, 3)
    np.testing.assert_array_equal(got, jax_vis.colorize_depth(est, **kwargs))


def test_colorize_error_and_summary_match_jax(tmp_path):
    est, gt, mask = _maps(1)
    np.testing.assert_array_equal(vis.colorize_error(est, gt),
                                  jax_vis.colorize_error(est, gt))
    np.testing.assert_array_equal(vis.colorize_error(est, gt, mask, 4.0),
                                  jax_vis.colorize_error(est, gt, mask, 4.0))
    panel = vis.depth_image_summary(est, gt, mask)
    assert panel.shape == (20, 72, 3)
    np.testing.assert_array_equal(panel,
                                  jax_vis.depth_image_summary(est, gt, mask))
    vis.save_depth_png(tmp_path / "d" / "depth.png", est, mask=mask)
    np.testing.assert_array_equal(read_png(tmp_path / "d" / "depth.png"),
                                  jax_vis.colorize_depth(est, mask))
    logger = ScalarLogger(tmp_path / "log", use_tensorboard=False)
    logger.log_image(7, "val/depth", panel)
    logger.close()
    np.testing.assert_array_equal(
        read_png(tmp_path / "log" / "images" / "val_depth_00000007.png"),
        panel)


def _task_pairs():
    model = torch.nn.Identity()
    return {"mvsnet": (tasks.MVSNetTask(model), jax_tasks.MVSNetTask(None)),
            "cascade": (tasks.CascadeTask(model),
                        jax_tasks.CascadeTask(None)),
            "pyramid": (tasks.PyramidTask(model),
                        jax_tasks.PyramidTask(None)),
            "point": (tasks.PointTask(model), jax_tasks.PointTask(None))}


@pytest.mark.parametrize("kind", ["mvsnet", "cascade", "pyramid", "point"])
def test_summary_triplet_matches_jax(kind):
    port_task, jax_task = _task_pairs()[kind]
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 2, (2, 6, 8)).astype(np.float32)

    def maps(shape):
        return rng.uniform(0, 2, shape).astype(np.float32)

    batch = {
        "mvsnet": {"depth_gt": maps((2, 6, 8)), "mask": maps((2, 6, 8))},
        "cascade": {"depth_gt": {f"stage{i}": maps((2, 6, 8))
                                 for i in (1, 2, 3)},
                    "mask": {f"stage{i}": maps((2, 6, 8))
                             for i in (1, 2, 3)}},
        "pyramid": {"depth_gt_levels": [maps((2, 6, 8)), maps((2, 3, 4))],
                    "mask_levels": [maps((2, 6, 8)), maps((2, 3, 4))]},
        "point": {"depth_gt": maps((2, 12, 16))},
    }[kind]
    got = train._summary_triplet(port_task, {"depth": torch.tensor(depth)},
                                 tasks.batch_to_device(batch, "cpu"))
    want = jax_train._summary_triplet(jax_task, {"depth": depth}, batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=2,
                    num_views=3, height=32, width=64, num_depth=16,
                    num_lights=1, tilt=(0.05, 0.02))


def _args(root, log_dir, *extra):
    return ["--device", "cpu", "model.ndepths=8,8,8", "data.num_views=3",
            "data.num_depth=16", "data.interval_scale=1.0",
            f"data.root={root}",
            f"data.train_list={root / 'lists' / 'train.txt'}",
            f"data.val_list={root / 'lists' / 'val.txt'}",
            "data.batch_size=3", "train.epochs=1",
            f"train.log_dir={log_dir}", *extra]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    # TensorBoard's import pulls in TensorFlow on this host (~20 s).
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)


def test_cli_train_writes_the_val_panel(root, tmp_path):
    out = train.main(_args(root, tmp_path))
    assert out["step"] == 1
    panel = read_png(tmp_path / "images" / "val_depth_00000001.png")
    assert panel.ndim == 3 and panel.shape[1] == 3 * 64 and \
        panel.shape[0] == 32
    assert panel.any()


def test_debug_nans_raises_on_a_nan_image(root, tmp_path, monkeypatch):
    getitem = DTUTrainDataset.__getitem__

    def with_nan(self, idx):
        item = getitem(self, idx)
        item["imgs"] = item["imgs"].copy()
        item["imgs"][0, 5, 7, 1] = np.nan
        return item

    monkeypatch.setattr(DTUTrainDataset, "__getitem__", with_nan)
    monkeypatch.setenv("MVS_TPU_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="step 1"):
        train.main(_args(root, tmp_path))
    assert not torch.is_anomaly_enabled()

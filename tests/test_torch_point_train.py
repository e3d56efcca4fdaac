"""The port's Point-MVSNet training pieces against mvs_tpu's on the CPU:
masked_mae, point_mvsnet_loss, interval_metrics, collate_point, PointTask
(its loss and metrics on fixed outputs), one train step, and cli train's
choice of task (the CLI run itself is in tests/test_torch_train_cli.py).

GT. The loss and the metrics pick the GT at each prediction's resolution
with jax.image.resize "nearest": source pixel floor((i + 0.5) * in / out),
8i + 4 at 1/8 where torch's "nearest" takes 8i. Every GT here varies from
pixel to pixel (with zeros, the invalid pixels), so picking another pixel
shows.

The train step: 64x80 images, 2 views, batch 2, 16 coarse hypotheses (so
that VolumeConv's coarsest BatchNorm sees 16 voxels), one flow iteration
at 1/4 (interval factor 0.75; two iterations and three
views, as in tests/test_torch_point_mvsnet.py, put mvs_tpu's float64
compile past this file's minute), BatchNorm from Flax's initial state
(count 0), both sides from the same variables, the GT from collate_point.
The flow's depth keeps its gradient in train mode, so the flow's loss
reaches the coarse stage through the hypotheses (the warp's hypothesis
gradient) and through the xyz. Both sides run on mvs_tpu's kNN graphs
(test_torch_point_mvsnet.run_on_jax_graphs: the port's lattices within
1e-9 of mvs_tpu's float64 ones in float64 and 5e-4 in f32, and its
lattice_knn exact on them; near ties on the regular lattice are decided by
the last bit). Bounds as
tests/test_torch_cvp_train.py's, against mvs_tpu's step in float64 (its
jnp.float32 read as float64): the port's f32 loss and metrics rtol 1e-5,
its float64 loss rtol 1e-12; its float64 gradients within 1e-9 of each
parameter's largest magnitude; each of its f32 gradients within 1e-3 of
the float64 gradient's largest magnitude, or within 30x what one f32
rounding of the images moves it; the new BatchNorm statistics within 1e-4
of each vector's largest magnitude, count 1 (2 for nothing here: one flow
iteration). For the float64 step mvs_tpu's pixel grid is taken in
float64 too (its dtype defaults to an f32 bound at import, and its f32
jnp.linspace rounds some pixel centres by 2^-22; the port's are exact).

The coarse tower's f32 gradients lie up to 9.1e-3 of their largest
magnitude from float64 here, far past the rest. mvs_tpu's f32 step, run
on the same graphs, is held against the same float64 gradients over four
draws (the batch and the three with the images moved by one f32
rounding): both packages' worst toggles between ~1e-4 and 9.1e-3 from
draw to draw (port 9.1e-3 / 2.0e-4 / 9.1e-3 / 8.3e-5, mvs_tpu 1.1e-4 /
2.0e-4 / 9.1e-3 / 9.1e-3), so the gap is a limit of f32 at this step,
not a rounding of the port's. The bound: each coarse-tower parameter's
smallest and largest error over the draws within twice mvs_tpu's, or
under 1e-4. The test prints the split between the three suspects, which
it does not hold: on the batch the masked MAE's sign flips at no pixel
(no depth lies within f32's reach of its GT), and the warps' samples
that change cell between f32 and float64 (6 on the batch), each sampled
in float64's cell, leave the worst at 9.1e-3: bilinear's slope jumps do
not carry it; with BatchNorm computed in float64 it falls to 1.6e-4: the
step's BatchNorms carry it.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvs_tpu.ops.folded_conv  # noqa: F401 (imported lazily by its
# blocks; here before the float64 step patches mvs_tpu's modules' jnp)
from mvs_tpu.io import dtu as jax_dtu
from mvs_tpu.models import point_mvsnet as jax_model
from mvs_tpu.models.point_mvsnet import PointMVSNet as JaxPointMVSNet
from mvs_tpu.train import losses as jax_losses
from mvs_tpu.train import metrics as jax_metrics
from mvs_tpu.train.tasks import PointTask as JaxPointTask
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io.dtu import DTUTrainDataset, collate_point
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.nn import blocks
from mvs_tpu_torch.train import losses, metrics
from mvs_tpu_torch.train.tasks import PointTask, batch_to_device
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_point_mvsnet import (flax_variables, jax_graphs,
                                     run_on_jax_graphs)
from test_torch_train import (F32_ROUNDING, ROUNDING_FACTOR, _Float64Numpy,
                              _flax_grads_to_torch, _gradient_errors,
                              _nudged, _to_float64)

H, W, VIEWS, NUM_DEPTH = 64, 80, 2, 16
MODEL = dict(flow_scales=(0.25,), inter_scales=(0.75,))
INPUTS = ("imgs", "intrinsics", "extrinsics", "depth_start",
          "depth_interval")


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _gt(seed, shape=(2, 32, 48)):
    """A GT varying per pixel with a fifth of it invalid (0)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(500, 900, shape).astype(np.float32)
    return np.where(rng.uniform(0, 1, shape) < 0.2, 0.0, gt).astype(
        np.float32)


def _preds(seed, gt_shape=(2, 32, 48)):
    rng = np.random.default_rng(seed)
    b, h, w = gt_shape
    return {"coarse_depth": rng.uniform(500, 900, (b, h // 8, w // 8)),
            "flow1": rng.uniform(500, 900, (b, h // 4, w // 4)),
            "flow2": rng.uniform(500, 900, (b, h // 2, w // 2))}


def test_masked_mae_matches_jax():
    rng = np.random.default_rng(0)
    est, gt = rng.uniform(0, 10, (2, 5, 6)), rng.uniform(0, 10, (2, 5, 6))
    mask = (rng.uniform(0, 1, (2, 5, 6)) > 0.4).astype(np.float32)
    for scale in (1.0, 2.5):
        np.testing.assert_allclose(
            float(losses.masked_mae(_t(est), _t(gt), _t(mask), scale)),
            float(jax_losses.masked_mae(est.astype(np.float32),
                                        gt.astype(np.float32), mask, scale)),
            rtol=1e-6)
    assert float(losses.masked_mae(_t(est), _t(gt), _t(0 * mask))) == 0.0


@pytest.mark.parametrize("flows", [0, 1, 2])
def test_point_mvsnet_loss_matches_jax(flows):
    """The coarse term and each flow's that the predictions have; the GT
    at 1/8, 1/4 and 1/2 picked at 8i + 4, 4i + 2 and 2i + 1."""
    gt, interval = _gt(1), np.array([2.5, 3.0], np.float32)
    preds = _preds(2)
    preds = {k: v.astype(np.float32) for k, v in preds.items()
             if k == "coarse_depth" or int(k[-1]) <= flows}
    want, want_parts = jax_losses.point_mvsnet_loss(
        jax.tree.map(jnp.asarray, preds), jnp.asarray(gt),
        jnp.asarray(interval))
    got, parts = losses.point_mvsnet_loss(
        {k: _t(v) for k, v in preds.items()}, _t(gt), _t(interval))
    assert set(parts) == set(want_parts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   rtol=1e-6, err_msg=k)
    # torch's "nearest" (pixel 8i) would give another loss.
    wrong = losses.masked_mae(
        _t(preds["coarse_depth"]), _t(gt[:, ::8, ::8]),
        _t(gt[:, ::8, ::8] > 0), _t(interval)[:, None, None])
    assert abs(float(wrong) - float(parts["coarse_loss"])) > 1e-3


def test_interval_metrics_match_jax():
    rng = np.random.default_rng(3)
    gt = _gt(3, (2, 6, 7))
    est = (gt + rng.normal(0, 3, gt.shape)).astype(np.float32)
    mask = (gt > 0).astype(np.float32)
    interval = np.array([2.0, 2.5], np.float32)
    want = jax_metrics.interval_metrics(est, gt, mask, interval,
                                        prefix="coarse_")
    got = metrics.interval_metrics(_t(est), _t(gt), _t(mask), _t(interval),
                                   prefix="coarse_")
    assert set(got) == set(want) == {"coarse_lt1_interval",
                                     "coarse_lt3_interval"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert 0 < float(got["coarse_lt1_interval"]) < float(
        got["coarse_lt3_interval"]) <= 1


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=2,
                    num_views=4, height=32, width=48, num_depth=16,
                    num_lights=1, tilt=(0.05, 0.02))


def test_collate_point_matches_jax(train_root):
    """Intrinsics x4, the GT x4 by repetition (cv2's INTER_NEAREST at an
    integer factor), depth_start the samples' depth_min."""
    kw = dict(num_views=3, num_depth=16, interval_scale=1.06)
    ds = DTUTrainDataset(train_root, ["scan1"], **kw)
    jds = jax_dtu.DTUTrainDataset(train_root, ["scan1"], **kw)
    got = collate_point([ds[0], ds[2]])
    want = jax_dtu.collate_point([jds[0], jds[2]])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["depth_gt"].shape == (2, 32, 48)


def test_point_task_matches_jax():
    """PointTask's loss and metrics on fixed model outputs: the standard
    and interval metrics of the depth, the coarse interval metrics and
    the loss's terms, against mvs_tpu's PointTask on the same outputs."""
    gt, interval = _gt(4), np.array([2.5, 3.0], np.float32)
    preds = {k: v.astype(np.float32) for k, v in _preds(5).items()}
    preds["depth"] = preds["flow2"]

    class Fixed(torch.nn.Module):
        def forward(self, *args, **kwargs):
            return {k: _t(v) for k, v in preds.items()}

    batch = {"depth_gt": _t(gt), "depth_interval": _t(interval),
             **{k: None for k in INPUTS[:-1]}}
    loss, got = PointTask(Fixed(), num_depth=8).loss_and_metrics(batch)
    jtask = JaxPointTask(None, num_depth=8)
    jtask.forward = lambda *a, **k: (jax.tree.map(jnp.asarray, preds), None)
    want_loss, (_, want) = jtask.loss_and_metrics(
        None, None, {"depth_gt": jnp.asarray(gt),
                     "depth_interval": jnp.asarray(interval)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _train_batch():
    """2 tilted plane scenes as the training split gives them (intrinsics
    and GT at 1/4 of the images, a fifth of the GT invalid) through
    collate_point; ladders from 8.2 and 8.0."""
    samples = []
    for seed, start in ((0, 8.2), (1, 8.0)):
        scene = make_plane_scene(num_views=VIEWS, height=H, width=W,
                                 z0=10.0, seed=seed, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = scene.depths[0][::4, ::4].astype(np.float32)
        gt[np.random.default_rng(seed).uniform(0, 1, gt.shape) < 0.2] = 0.0
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_min=np.float32(start),
            depth_interval=np.float32(4.0 / (NUM_DEPTH - 1)), depth_gt=gt))
    return collate_point(samples)


def _port_step(state, batch, graphs, dtype=torch.float32, check_knn=True,
               xyz_atol=None):
    """Loss, metrics, gradients and state after one train-mode forward and
    backward of the port, on mvs_tpu's graphs (recorded on a lattice within
    `xyz_atol` of the port's)."""
    model = PointMVSNet(num_depth=NUM_DEPTH, **MODEL).to(dtype)
    model.load_state_dict(state)
    model.train()
    tb = {k: v.to(dtype) for k, v in batch_to_device(batch, "cpu").items()}
    # The port's lattices against mvs_tpu's float64 ones: within 1e-9 in
    # float64; in f32 within 5e-4 (the train-mode coarse depth near 10
    # moves by up to 1e-5 of itself between f32 and float64).
    (value, metrics_), _ = run_on_jax_graphs(
        lambda: PointTask(model, num_depth=NUM_DEPTH).loss_and_metrics(tb),
        graphs, xyz_atol or (1e-9 if dtype == torch.float64 else 5e-4),
        check_knn)
    value.backward()
    return dict(loss=value.item(),
                metrics={k: float(v) for k, v in metrics_.items()},
                grads={k: p.grad for k, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def step():
    batch = _train_batch()
    variables = flax_variables(PointMVSNet(**MODEL), seed=8, count=0.0)
    state = flax_to_state_dict(variables)
    task = JaxPointTask(JaxPointMVSNet(**MODEL), num_depth=NUM_DEPTH)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: task.loss_and_metrics(p, s, b, train=True),
        has_aux=True))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # mvs_tpu pins its moments, convs' sums and regression to
        # jnp.float32: read as float64 there; torch's .float() keeps
        # float64 for the port's float64 step.
        for name, module in list(sys.modules.items()):
            if name.split(".")[0] == "mvs_tpu" and \
                    getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", _Float64Numpy())
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                   torch.float64 else t.to(torch.float32))
        # Its pixel grid's dtype is bound when the module is imported
        # (jnp.linspace in f32, which rounds some centres by 2^-22).
        mp.setattr(jax_model, "point_pixel_grid", functools.partial(
            jax_model.point_pixel_grid, dtype=jnp.float64))
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            v = _to_float64(variables)
            ((loss, (new_stats, metrics_)), grads), graphs = jax_graphs(
                lambda: fn(v["params"], v["batch_stats"],
                           _to_float64(batch)))
            out.update(
                jax_loss=float(loss),
                jax_metrics={k: float(x) for k, x in metrics_.items()},
                jax_grads=_flax_grads_to_torch(jax.tree.map(np.asarray,
                                                            grads)),
                jax_stats=flax_to_state_dict(jax.tree.map(np.asarray, {
                    "params": variables["params"],
                    "batch_stats": new_stats})),
                port64=_port_step({k: t.double() for k, t in state.items()},
                                  batch, graphs, torch.float64))
        finally:
            jax.config.update("jax_enable_x64", x64)
    out["port"] = _port_step(state, batch, graphs)
    moved = {}
    for seed in range(3):
        nudged = _nudged(batch, seed, F32_ROUNDING)
        for k, g in _port_step(state, nudged, graphs,
                               check_knn=False)["grads"].items():
            moved.setdefault(k, []).append(g)
    out["moved"] = moved
    out.update(variables=variables, state=state, batch=batch, graphs=graphs)
    return out


def test_train_step_loss_and_metrics(step):
    got, want = step["port"]["metrics"], step["jax_metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(step["port"]["loss"], step["jax_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(step["port64"]["loss"], step["jax_loss"],
                               rtol=1e-12)
    assert 0 < step["jax_loss"] < 100


def test_train_step_float64_gradients_agree(step):
    port, want = step["port64"]["grads"], step["jax_grads"]
    assert set(port) == set(want)
    for k, (err, _, _) in _gradient_errors(port, want).items():
        assert err <= 1e-9, (k, err)
    # The flow's loss reaches the coarse tower through the hypotheses.
    assert float(want["coarse_img_conv.ConvBlock_0.Conv_0.kernel"].abs()
                 .max()) > 0


def test_train_step_gradients(step):
    got, exact = step["port"]["grads"], step["jax_grads"]
    assert set(got) == set(exact)
    beyond = {}
    for k, (err, _, _) in _gradient_errors(got, exact).items():
        scale = float(exact[k].abs().max())
        moved = max(float((g - got[k]).abs().max()) for g in step["moved"][k])
        if err > 1e-3 and err > ROUNDING_FACTOR * moved / scale:
            beyond[k] = (err, moved / scale)
    assert beyond == {}


def _in_cells(feat, coords, cells):
    """geometry.sampling.bilinear_sample of `feat` at `coords` with each
    sample's corner cell given (`cells`, the floors of another run's
    coords): a sample past a cell edge keeps that cell's slopes."""
    *lead, h, w, c = feat.shape
    nb = int(np.prod(lead))
    xy = coords.reshape(nb, -1, 2)
    x0, y0 = cells.reshape(nb, -1, 2).to(xy.dtype).unbind(-1)
    wx = (xy[..., 0] - x0).to(feat.dtype)[..., None]
    wy = (xy[..., 1] - y0).to(feat.dtype)[..., None]
    flat = feat.reshape(nb * h * w, c)
    base = (torch.arange(nb) * (h * w))[:, None]

    def corner(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat[idx.reshape(-1)].reshape(nb, -1, c) * valid[..., None]

    x0, y0 = x0.long(), y0.long()
    out = ((corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx) * (1 - wy)
           + (corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx)
           * wy)
    return out.reshape(*lead, *coords.shape[len(lead):-1], c)


def _normalize_in_float64(self, y):
    """BatchStats.normalize_batch computed in float64, returned in f32."""
    y64, dims = y.double(), tuple(range(y.ndim - 1))
    mean = y64.mean(dims)
    var = torch.clamp((y64 * y64).mean(dims) - mean * mean, min=0.0)
    self.record(mean.float().detach(), var.float().detach())
    return ((y64 - mean) * self.scale.double() * torch.rsqrt(var + 1e-5)
            + self.bias.double()).float()


def _probed_step(step, batch, dtype, cells=None):
    """_port_step on step()'s graphs that also returns each masked MAE
    term's est - gt and each warp's sample cells (floors); with `cells`,
    every warp samples in those cells."""
    import mvs_tpu_torch.geometry.homography as homography

    terms, floors, sample = [], [], homography.bilinear_sample

    def mae(est, gt, mask, scale=1.0):
        terms.append(((est - gt).detach().double(), mask > 0.5))
        return masked_mae(est, gt, mask, scale)

    def warp(feat, coords):
        floors.append(torch.floor(coords.detach().double()))
        if cells is None:
            return sample(feat, coords)
        return _in_cells(feat, coords, cells[len(floors) - 1])

    masked_mae = losses.masked_mae
    state = step["state"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(losses, "masked_mae", mae)
        mp.setattr(homography, "bilinear_sample", warp)
        if dtype == torch.float64:
            mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                       torch.float64 else t.to(torch.float32))
            state = {k: t.double() for k, t in state.items()}
        grads = _port_step(state, batch, step["graphs"], dtype,
                           check_knn=False, xyz_atol=5e-4)["grads"]
    return grads, terms, floors


# The f32 gradient gap's draws: the batch and step()'s three with the
# images moved by one f32 rounding.
F32_DRAWS = (None, 0, 1, 2)


@pytest.fixture(scope="module")
def f32_gap(step):
    """For each of F32_DRAWS: the port's float64 and f32 gradients and
    mvs_tpu's f32 gradients, both packages on step()'s kNN graphs (the
    float64 run's; mvs_tpu's lattice_knn answers with the recorded graph
    of the nearest lattice); and on the batch the port's f32 step probed
    for the three suspects."""
    graphs, batch = step["graphs"], step["batch"]

    def recorded(xyz):
        xyz = np.asarray(xyz, np.float64)
        same = [g for g in graphs if g[0].shape[1:] == xyz.shape]
        best = min(same, key=lambda g: np.abs(g[0][0] - xyz).max())
        return best[1][0].astype(np.int32)

    def knn(xyz, kernel_size, k):
        shape = jax.ShapeDtypeStruct((int(np.prod(xyz.shape[1:])), k),
                                     jnp.int32)
        return jax.pure_callback(recorded, shape, jax.lax.stop_gradient(xyz),
                                 vmap_method="sequential")

    task = JaxPointTask(JaxPointMVSNet(**MODEL), num_depth=NUM_DEPTH)
    v = step["variables"]
    out = {"port": [], "port64": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "lattice_knn", knn)
        fn = jax.jit(jax.grad(lambda p, s, b: task.loss_and_metrics(
            p, s, b, train=True)[0]))
        for i, seed in enumerate(F32_DRAWS):
            b = _nudged(batch, seed, F32_ROUNDING)
            out["jax"].append(_flax_grads_to_torch(jax.tree.map(
                np.asarray, fn(v["params"], v["batch_stats"], b))))
            out["port"].append(step["port"]["grads"] if seed is None else
                               {k: g[seed] for k, g in step["moved"].items()})
            out["port64"].append(step["port64"]["grads"] if seed is None
                                 else _probed_step(step, b, torch.float64)[0])
    _, out["terms64"], out["floors64"] = _probed_step(step, batch,
                                                      torch.float64)
    out["pinned"], out["terms"], out["floors"] = _probed_step(
        step, batch, torch.float32, cells=out["floors64"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks.BatchStats, "normalize_batch",
                   _normalize_in_float64)
        out["bn64"] = _port_step(step["state"], batch, graphs)["grads"]
    return out


def _coarse_errors(got, exact) -> dict:
    """Each coarse-tower parameter's largest error over its largest
    magnitude."""
    keys = [k for k in exact if k.startswith(COARSE)]
    return {k: e[0] for k, e in _gradient_errors(
        {k: got[k] for k in keys}, {k: exact[k] for k in keys}).items()}


COARSE = ("coarse_img_conv", "coarse_vol_conv")
# An f32 gradient error under this share of the largest magnitude is no
# gap (the step's f32 gradients sit 1e-5 to 1e-4 from float64 at best).
GAP_FLOOR = 1e-4


def test_f32_gradient_gap_is_mvs_tpus_too(f32_gap):
    """The coarse tower's f32 gradients against float64 (module docstring):
    over the draws, each parameter's smallest and largest error within
    twice mvs_tpu's own (its f32 step on the same graphs). Printed, not
    held: the gap split between the three suspects on the batch (the
    masked MAE's sign flips; the worst error with the warps' samples that
    change cell between f32 and float64, bilinear's slope jumps at a cell
    edge, sampled in float64's cells; the worst with BatchNorm computed in
    float64)."""
    port = [_coarse_errors(g, x) for g, x in zip(f32_gap["port"],
                                                 f32_gap["port64"])]
    ref = [_coarse_errors(g, x) for g, x in zip(f32_gap["jax"],
                                                f32_gap["port64"])]
    worst = [max(e.values()) for e in port]
    print("coarse tower, worst f32 error per draw: port "
          + " ".join(f"{x:.3e}" for x in worst) + ", mvs_tpu "
          + " ".join(f"{max(e.values()):.3e}" for e in ref))
    for k in port[0]:
        for pick in (min, max):
            mine, theirs = (pick(e[k] for e in errs) for errs in (port, ref))
            assert mine <= max(2 * theirs, GAP_FLOOR), (k, pick.__name__,
                                                       mine, theirs)
    flips = sum(int((((a > 0) != (b > 0)) & m).sum()) for (a, m), (b, _) in
                zip(f32_gap["terms64"], f32_gap["terms"]))
    crossed = sum(int((a != b).any(-1).sum()) for a, b in
                  zip(f32_gap["floors64"], f32_gap["floors"]))
    pinned = max(_coarse_errors(f32_gap["pinned"],
                                f32_gap["port64"][0]).values())
    bn64 = max(_coarse_errors(f32_gap["bn64"], f32_gap["port64"][0]).values())
    print(f"batch: worst {worst[0]:.3e}; MAE sign flips {flips}; samples "
          f"past a cell edge {crossed}, in float64's cells {pinned:.3e}; "
          f"BatchNorm in float64 {bn64:.3e}")


def test_train_step_batch_stats(step):
    want, got = step["jax_stats"], step["port"]["state"]
    stats = [k for k in want if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                         "count")]
    # 2 x 10 ImageConv blocks, 10 VolumeConv blocks, 3 EdgeConvs, 3 MLP
    # layers.
    assert len(stats) == 3 * 36
    for k in stats:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        if k.endswith("count"):
            assert float(got[k]) == 1.0


def test_cli_build_task_takes_point_task():
    """cli train's build_task gives model.name=point_mvsnet PointTask with
    model.num_depth_coarse and collate_point, as mvs_tpu's registry does
    (the CLI itself: tests/test_torch_train_cli.py)."""
    from mvs_tpu_torch.cli.train import build_task

    cfg = load_config(None, ["model.name=point_mvsnet",
                             "model.num_depth_coarse=24"])
    task, collate = build_task(cfg, torch.nn.Identity())
    assert isinstance(task, PointTask) and task.num_depth == 24
    assert collate is collate_point

"""The port's process mesh and the collectives of its global-batch train
step (mvs_tpu_torch.parallel) against mvs_tpu.parallel on the CPU.

Ranks are real processes over gloo (tests/_torch_dist_worker.py, started by
parallel.launch_local with a timeout; every rank is killed when it ends).
mvs_tpu runs on the virtual CPU devices of tests/conftest.py. Bounds:
  * the view shards' plain partial sums against mvs_tpu's per-shard sums
    and against make_view_variance on a view=2 mesh: 1e-5 of the largest
    magnitude (f32 sums of the same samples in another order);
  * BatchNorm's global moments and their gradient against the global
    batch's: 1e-6 (two f32 means of equal halves averaged, against one);
  * the masked loss and OHEM summed over two ranks against the one-process
    value and mvs_tpu's on the whole batch: rtol 1e-6, their gradients
    concatenated against jax.grad's: rtol 1e-6, atol 1e-9;
  * make_view_variance's volume and each view rank's feature gradients
    (float64) against one process's volume and half its gradient: 1e-12
    of the largest magnitude (the features' cotangent summed over the
    view group and divided by its size);
  * the bf16 MVSNet view=2 step (f32 parameters) against one bf16
    process: loss rtol 1e-3 and update-norm ratio 1 +- 0.02 (chip_smoke.py
    13b's), every parameter's update within one bf16 rounding (2^-8) of
    its largest magnitude; the fix reverted lies past 10x that.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.ops.cost_volume import variance_from_partials as \
    jax_variance_from_partials
from mvs_tpu.parallel import make_mesh as jax_make_mesh
from mvs_tpu.parallel import make_view_variance as jax_make_view_variance
from mvs_tpu.geometry.homography import warp_src_feature
from mvs_tpu.train import losses as jax_losses
from mvs_tpu_torch.io.pipeline import DataLoader
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.nn.blocks import BatchStats
from mvs_tpu_torch.ops.cost_volume import variance_from_partials
from mvs_tpu_torch.ops.warp_variance import (fused_variance_partials,
                                             fused_variance_volume)
from mvs_tpu_torch.parallel import (AXES, launch_local, make_mesh,
                                    maybe_initialize_distributed, shard_batch)
from mvs_tpu_torch.parallel.distributed import choose_backend
from mvs_tpu_torch.parallel.mesh import layout, mesh_shape_from_config
from mvs_tpu_torch.parallel.sharding import row_slice
from mvs_tpu_torch.train import losses
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_mvsnet_train import ZERO_GRADIENT, _train_batch
from test_torch_train import ZERO_GRADIENT as CAS_ZERO_GRADIENT
from test_torch_train import _train_batch as _cas_batch

import _torch_dist_worker as worker

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
DATA2, VIEW2 = (("data", 2),), (("view", 2),)
TRAIN_CASES = [("train", DATA2, "right", 1, "float64"),
               ("train", DATA2, "avg", 1, "float64"),
               ("train", DATA2, "mean_of_means", 1, "float64"),
               ("train", VIEW2, "right", 1, "float64"),
               ("train", VIEW2, "no_view_div", 1, "float64"),
               ("train", DATA2, "right", 2, "float32"),
               ("train", VIEW2, "right", 1, "float64", "cas"),
               ("train", VIEW2, "right", 1, "bfloat16"),
               ("train", VIEW2, "unshared", 1, "bfloat16")]
VIEW_SHARED = ("view_shared", VIEW2)


def run_ranks(inputs: dict, tmp_path, world: int = 2,
              timeout: float = 50.0) -> list:
    """Each rank's {case: result} from the worker over `world` gloo
    processes."""
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    ranks = launch_local([sys.executable, str(WORKER), str(path),
                          str(tmp_path)], world, timeout, cwd=ROOT)
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-3000:]}"
        assert out.startswith(f"rank {r}/{world}: torch.distributed backend "
                              f"gloo on cpu"), out[:200]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---- the mesh ---------------------------------------------------------------

def test_layout_puts_view_inside_data():
    lay = layout(data=2, view=2)
    assert lay["data"] == [[0, 2], [1, 3]]
    assert lay["view"] == [[0, 1], [2, 3]]
    assert lay["depth"] == [[0], [1], [2], [3]]
    # The same device order as mvs_tpu's mesh of 4 devices.
    jm = jax_make_mesh(data=2, view=2, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    grid = np.arange(4).reshape(2, 2, 1, 1)
    np.testing.assert_array_equal(ids - ids.min(), grid)
    assert AXES == jm.axis_names
    mesh = make_mesh(world_size=1)
    assert mesh.coords == dict.fromkeys(AXES, 0)
    assert all(g is None for g in mesh.groups.values())


@pytest.mark.parametrize("shape,err,match", [
    (dict(data=2), ValueError, r"needs 2 processes, have 1"),
    (dict(data=1, view=3), ValueError, r"needs 3 processes"),
    (dict(depth=2), ValueError, r"needs 2 processes, have 1"),
    (dict(space=2), ValueError, r"needs 2 processes, have 1"),
])
def test_mesh_errors(shape, err, match):
    """A mesh needs as many processes as its shape says, 'depth' and
    'space' too (their meshes are built over gloo ranks in
    tests/test_torch_volume_sharding.py); with as many, the shape's lines
    are its process groups."""
    with pytest.raises(err, match=match):
        make_mesh(**shape)
    if err is ValueError:  # mvs_tpu raises the same on as many devices
        with pytest.raises(ValueError, match="needs"):
            jax_make_mesh(**shape, devices=jax.devices()[:1])
    axis = next(a for a in AXES if shape.get(a, 1) > 1)
    assert layout(**shape)[axis] == [list(range(shape[axis]))]


def test_mesh_data_zero_fills_the_world():
    cfg = load_config(None, ["train.mesh_view=2"])
    assert cfg.train.mesh_data == 0
    assert mesh_shape_from_config(cfg.train, 8) == dict(data=4, view=2,
                                                        depth=1, space=1)


def test_backend_rule_and_single_process():
    cpu, card = torch.device("cpu"), torch.device("cuda:0")
    assert choose_backend(cpu, True, 2) == "gloo"
    assert choose_backend(card, False, 4) == "nccl"  # a card per rank
    assert choose_backend(card, True, 2) == "gloo"  # ranks share one card
    assert choose_backend(card, True, 1) == "nccl"
    info = maybe_initialize_distributed("cpu")
    assert (info.rank, info.world_size, info.backend) == (0, 1, None)
    assert not torch.distributed.is_initialized()


# ---- the global batch's rows -------------------------------------------------

class _Rows:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        return {"i": np.array([i])}


def _collate(samples):
    return {"i": np.concatenate([s["i"] for s in samples])}


def test_data_ranks_rows_make_the_global_batch():
    whole = [b["i"] for b in DataLoader(_Rows(), 4, _collate, seed=3)]
    parts = [[b["i"] for b in DataLoader(_Rows(), 4, _collate, seed=3,
                                         shard=(r, 2))] for r in range(2)]
    assert len(whole) == 3
    for w, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(np.concatenate([a, b]), w)
    with pytest.raises(ValueError, match="does not split over 3"):
        DataLoader(_Rows(), 4, _collate, shard=(0, 3))
    batch = {"x": np.arange(8).reshape(4, 2), "s": {"y": torch.arange(4)},
             "l": [np.arange(4)]}

    class _M:  # data rank 1 of 2, no process group needed
        def size(self, axis):
            return 2

        def coord(self, axis):
            return 1

    got = shard_batch(batch, _M())
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["s"]["y"].tolist() == [2, 3] and got["l"][0].tolist() == [2, 3]
    assert row_slice(4, (1, 2)) == slice(2, 4)
    with pytest.raises(ValueError, match="global batch 3"):
        row_slice(3, (1, 2))


# ---- the view shards' partial sums --------------------------------------------

def _views(num_views=5, c=6, seed=0):
    scene = make_plane_scene(num_views=num_views, height=24, width=32,
                             z0=10.0, seed=seed, tilt=(0.05, 0.02))
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(num_views, 24, 32, c)).astype(np.float32)
    proj = scene.projections.astype(np.float64)
    rels = np.stack([proj[v] @ np.linalg.inv(proj[0])
                     for v in range(1, num_views)]).astype(np.float32)
    depths = np.linspace(8.0, 12.0, 6, dtype=np.float32)
    return feats, rels, depths


@pytest.mark.parametrize("num_views,shards", [(5, 2), (3, 2), (4, 3),
                                              (5, 4)])
def test_partials_match_mvs_tpu_shards(num_views, shards):
    """Each view shard's plain Σf / Σf² against the same sums of mvs_tpu's
    warp (collectives.py's shard body), the reference added on shard 0
    only; the shards' sums give the variance of all views."""
    feats, rels, depths = _views(num_views)
    per = (num_views - 1) // shards
    ref = torch.from_numpy(feats[0])[None]
    hyp = torch.from_numpy(depths)[None, :, None, None].expand(
        1, -1, 24, 32).contiguous()
    total = [0.0, 0.0]
    for s in range(shards):
        local = slice(s * per, (s + 1) * per)
        sf, sq = fused_variance_partials(
            ref, torch.from_numpy(feats[1:][local])[None],
            torch.from_numpy(rels[local])[None], hyp, with_ref=s == 0)
        jf = jnp.zeros((6, 24, 32, feats.shape[-1]))
        jq = jnp.zeros_like(jf)
        for v in range(s * per, (s + 1) * per):
            w = warp_src_feature(jnp.asarray(feats[1 + v]),
                                 jnp.asarray(rels[v]), jnp.asarray(depths))
            jf, jq = jf + w, jq + w * w
        if s == 0:
            jf = jf + feats[0][None]
            jq = jq + feats[0][None] ** 2
        for got, want in ((sf[0], jf), (sq[0], jq)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        total = [total[0] + sf, total[1] + sq]
    dense = fused_variance_volume(
        ref, torch.from_numpy(feats[1:])[None], torch.from_numpy(rels)[None],
        hyp)
    var = np.asarray(jax_variance_from_partials(
        jnp.asarray(total[0].numpy()), jnp.asarray(total[1].numpy()),
        num_views))
    np.testing.assert_allclose(var, dense.numpy(), rtol=0,
                               atol=1e-5 * float(dense.abs().max()))


def test_partials_match_make_view_variance():
    """Two view shards' plain partials, summed, against mvs_tpu's
    make_view_variance on a data=1 view=2 mesh (one psum)."""
    feats, rels, depths = _views(5, seed=1)
    jm = jax_make_mesh(data=1, view=2, devices=jax.devices()[:2])
    want = np.asarray(jax.jit(jax_make_view_variance(jm))(
        jnp.asarray(feats[:1]), jnp.asarray(feats[None, 1:]),
        jnp.asarray(rels[None]), jnp.asarray(depths[None])))
    ref = torch.from_numpy(feats[:1])
    hyp = torch.from_numpy(depths)[None, :, None, None].expand(
        1, -1, 24, 32).contiguous()
    sums = [fused_variance_partials(
        ref, torch.from_numpy(feats[None, 1 + 2 * s:3 + 2 * s]),
        torch.from_numpy(rels[None, 2 * s:2 * s + 2]), hyp, with_ref=s == 0)
        for s in range(2)]
    got = variance_from_partials(sums[0][0] + sums[1][0],
                                 sums[0][1] + sums[1][1], 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- BatchNorm, masked losses and OHEM over two ranks ---------------------------

def _primitive_inputs():
    rng = np.random.default_rng(7)
    shape = (4, 9, 11)
    est = rng.uniform(400, 900, shape).astype(np.float32)
    gt = (est + rng.normal(0, 3, shape)).astype(np.float32)
    # Unequal mask counts: rows of rank 0 mostly valid, rank 1's sparse.
    share = np.array([0.9, 0.8, 0.2, 0.1])[:, None, None]
    mask = (rng.uniform(0, 1, shape) < share).astype(np.float32)
    return dict(
        topk=0.6,
        bn_y=torch.from_numpy(rng.normal(1, 2, (4, 3, 5, 6)).astype(
            np.float32)),
        bn_w=torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32)),
        est=torch.from_numpy(est), gt=torch.from_numpy(gt),
        mask=torch.from_numpy(mask))


def _view_shared_inputs():
    """make_view_variance's inputs (float64): a reference view and four
    source views at 24x32, C = 6, 6 planes, and the weights w of
    sum(volume * w)."""
    feats, rels, depths = _views(5, seed=2)
    f = torch.from_numpy(feats).double()
    return dict(
        vs_ref=f[:1], vs_src=f[None, 1:],
        vs_rel=torch.from_numpy(rels).double()[None],
        vs_hyp=torch.from_numpy(depths).double()[None, :, None, None].expand(
            1, -1, 24, 32).contiguous(),
        vs_w=torch.from_numpy(np.random.default_rng(3).normal(
            size=(1, 6, 24, 32, 6))))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of two gloo ranks for every case of this file."""
    batch = _train_batch()
    batch["mask"][1, :6] = 0.0  # unequal mask counts over the data ranks
    state = MVSNet(refine=False, trained=False,
                   generator=torch.Generator().manual_seed(3)).state_dict()
    cas_state = CasMVSNet(ndepths=(8, 8, 8), trained=False,
                          generator=torch.Generator().manual_seed(4)
                          ).state_dict()
    inputs = dict(cases=[("primitives", DATA2), VIEW_SHARED] + TRAIN_CASES,
                  state=state, loss="smooth_l1", batch=batch,
                  cas_state=cas_state, cas_batch=_cas_batch(),
                  **_primitive_inputs(), **_view_shared_inputs())
    results = run_ranks(inputs, tmp_path_factory.mktemp("ranks"))
    stored = {"float64": torch.float64, "float32": torch.float32,
              "bfloat16": torch.float32}  # bf16: f32 parameters
    single = {(steps, dtype, name): worker.train(
        dict(inputs, state={k: v.to(stored[dtype])
                            for k, v in state.items()},
             cas_state={k: v.to(stored[dtype])
                        for k, v in cas_state.items()}),
        make_mesh(), "right", steps, dtype, name)
        for steps, dtype, name in ((1, "float64", "mvsnet"),
                                   (2, "float32", "mvsnet"),
                                   (1, "float64", "cas"),
                                   (1, "bfloat16", "mvsnet"))}
    return dict(inputs=inputs, results=results, single=single)


@pytest.fixture(scope="module")
def primitives(ranks):
    return ranks["inputs"], [r[("primitives", DATA2)]
                             for r in ranks["results"]]


def test_batch_norm_moments_are_the_global_batch(primitives):
    inputs, ranks = primitives
    y = inputs["bn_y"].clone().requires_grad_(True)
    mean, var = BatchStats.batch_moments(y)
    (grad,) = torch.autograd.grad((mean * inputs["bn_w"][0]).sum()
                                  + (var * inputs["bn_w"][1]).sum(), y)
    for r in ranks:
        torch.testing.assert_close(r["bn"]["mean"], mean.detach(), rtol=0,
                                   atol=1e-6 * float(mean.detach().abs().max()))
        torch.testing.assert_close(r["bn"]["var"], var.detach(), rtol=0,
                                   atol=1e-6 * float(var.detach().abs().max()))
    both = torch.cat([r["bn"]["grad"] for r in ranks])
    torch.testing.assert_close(both, grad, rtol=0,
                               atol=1e-6 * float(grad.abs().max()))
    assert [r["coords"]["data"] for r in ranks] == [0, 1]


def test_masked_loss_is_global_where_a_mean_of_rank_means_is_not(primitives):
    inputs, ranks = primitives
    est = inputs["est"].clone().requires_grad_(True)
    whole = losses.masked_smooth_l1(est, inputs["gt"], inputs["mask"])
    (grad,) = torch.autograd.grad(whole, est)
    want, want_grad = jax.value_and_grad(
        lambda e: jax_losses.masked_smooth_l1(
            e, inputs["gt"].numpy(), inputs["mask"].numpy()))(
                jnp.asarray(inputs["est"].numpy()))
    counts = inputs["mask"].reshape(2, -1).sum(1)
    assert counts[0] > 3 * counts[1]
    for r in ranks:
        np.testing.assert_allclose(float(r["masked"]["total"]), whole.item(),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(r["masked"]["total"]), float(want),
                                   rtol=1e-6)
        # Each rank's own mean, averaged: another loss.
        assert abs(float(r["mean_of_means"]) / whole.item() - 1) > 0.01
    np.testing.assert_allclose(float(sum(r["masked"]["share"]
                                         for r in ranks)), whole.item(),
                               rtol=1e-6)
    got = torch.cat([r["masked"]["grad"] for r in ranks])
    np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_grad), rtol=1e-6,
                               atol=1e-9)


def test_ohem_ranks_the_global_batch(primitives):
    """OHEM over two ranks selects the pixels mvs_tpu's selects on the whole
    batch: k from the global valid count, the threshold from the global
    ranking (the ranks' own top-k would take other pixels)."""
    inputs, ranks = primitives
    topk = inputs["topk"]
    want, want_grad = jax.value_and_grad(
        lambda e: jax_losses.ohem_smooth_l1(
            e, inputs["gt"].numpy(), inputs["mask"].numpy(), topk))(
                jnp.asarray(inputs["est"].numpy()))
    for r in ranks:
        np.testing.assert_allclose(float(r["ohem"]["total"]), float(want),
                                   rtol=1e-6)
    got = torch.cat([r["ohem"]["grad"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, np.asarray(want_grad), rtol=1e-6,
                               atol=1e-9)
    taken = int((got != 0).sum())
    n_valid = int(inputs["mask"].sum())
    assert taken == int(np.floor(np.float32(topk) * np.float32(n_valid)))
    # The ranks' own top-k would take another count of pixels from each.
    for r, m in zip(ranks, inputs["mask"].reshape(2, -1)):
        own = int(np.floor(np.float32(topk) * np.float32(m.sum())))
        assert int((r["ohem"]["grad"] != 0).sum()) != own


# ---- the train step over two ranks ---------------------------------------------

def _updates(result, state):
    """Each parameter's update, the score bias aside: the softmax over depth
    is invariant to it, so its exact gradient is 0 and both sides hold
    rounding residue."""
    return {k: result["state"][k].double() - state[k].double()
            for k in state if not k.endswith(("mean", "var", "count"))
            and k not in ZERO_GRADIENT}


def _deviation(got, want) -> float:
    """The largest parameter deviation over its update's largest
    magnitude."""
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def _norm_ratio(got, want) -> float:
    return float(torch.sqrt(sum((g ** 2).sum() for g in got.values()))
                 / torch.sqrt(sum((w ** 2).sum() for w in want.values())))


def test_data_parallel_step_equals_one_process(ranks):
    want = ranks["single"][(1, "float64", "mvsnet")]
    want_upd = _updates(want, ranks["inputs"]["state"])
    counts = ranks["inputs"]["batch"]["mask"].reshape(2, -1).sum(1)
    assert counts[0] != counts[1], counts
    for rank in ranks["results"]:
        got = rank[TRAIN_CASES[0]]
        assert got["coords"]["data"] in (0, 1)
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-12)
        for k in ("abs_depth_error", "thres2mm_error"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-9)
        assert _deviation(_updates(got, ranks["inputs"]["state"]), want_upd) < 1e-9
        for k in want["state"]:
            if k.endswith(("mean", "var")):  # global BatchNorm statistics
                torch.testing.assert_close(got["state"][k], want["state"][k],
                                           rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mode,ratio", [("avg", 0.5),
                                        ("mean_of_means", None)])
def test_wrong_data_parallel_rules_fail(ranks, mode, ratio):
    want = ranks["single"][(1, "float64", "mvsnet")]
    want_upd = _updates(want, ranks["inputs"]["state"])
    case = ("train", DATA2, mode, 1, "float64")
    for rank in ranks["results"]:
        got = _updates(rank[case], ranks["inputs"]["state"])
        assert _deviation(got, want_upd) > 1e-3
        if ratio is not None:
            assert _norm_ratio(got, want_upd) == pytest.approx(ratio, 1e-6)
        else:  # another loss: the rows' mask counts differ
            assert abs(rank[case]["metrics"]["loss"]
                       / want["metrics"]["loss"] - 1) > 1e-4


@pytest.mark.parametrize("mode,ratio", [("right", 1.0),
                                        ("no_view_div", 2.0)])
def test_view_sharded_step_update_norm(ranks, mode, ratio):
    """view=2: each rank warps one of the two source views; the global
    update-norm ratio to the one-process step is 1 within 2%, and 2 without
    the 1 / |view| (the V-fold error)."""
    want = ranks["single"][(1, "float64", "mvsnet")]
    want_upd = _updates(want, ranks["inputs"]["state"])
    for rank in ranks["results"]:
        got = rank[("train", VIEW2, mode, 1, "float64")]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   ratio * want["metrics"]["loss"], rtol=1e-12)
        upd = _updates(got, ranks["inputs"]["state"])
        assert _norm_ratio(upd, want_upd) == pytest.approx(ratio, rel=0.02)
        if mode == "right":
            assert _deviation(upd, want_upd) < 1e-9
        else:
            assert _deviation(upd, want_upd) > 0.5


def test_ranks_hold_identical_parameters(ranks):
    a, b = (r[("train", DATA2, "right", 2, "float32")]
            for r in ranks["results"])
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    one = ranks["single"][(2, "float32", "mvsnet")]
    np.testing.assert_allclose(a["metrics"]["loss"], one["metrics"]["loss"],
                               rtol=1e-5)


def test_cascade_view_sharded_step_equals_one_process(ranks):
    """CasMVSNet's hook: each stage's volume from the two view ranks'
    partial sums (one source view each), float64, against one process."""
    want = ranks["single"][(1, "float64", "cas")]
    state = ranks["inputs"]["cas_state"]
    want_upd = {k: v for k, v in _updates(want, state).items()
                if k not in CAS_ZERO_GRADIENT}
    for rank in ranks["results"]:
        got = rank[("train", VIEW2, "right", 1, "float64", "cas")]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-12)
        upd = {k: v for k, v in _updates(got, state).items()
               if k not in CAS_ZERO_GRADIENT}
        assert _deviation(upd, want_upd) < 1e-9


def test_data_and_view_mesh_step_equals_one_process(ranks, tmp_path):
    """Four ranks on a data=2 x view=2 mesh (each data rank's rows, each
    view rank one source view), float64: every rank's update is the
    one-process step's to 1e-9."""
    case = ("train", (("data", 2), ("view", 2)), "right", 1, "float64")
    got = run_ranks(dict(ranks["inputs"], cases=[case]), tmp_path, world=4)
    want = ranks["single"][(1, "float64", "mvsnet")]
    want_upd = _updates(want, ranks["inputs"]["state"])
    assert [r[case]["coords"] for r in got] == [
        dict(data=d, view=v, depth=0, space=0) for d in (0, 1)
        for v in (0, 1)]
    for rank in got:
        np.testing.assert_allclose(rank[case]["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-12)
        assert _deviation(_updates(rank[case], ranks["inputs"]["state"]),
                          want_upd) < 1e-9


def test_view_ranks_features_take_the_groups_mean_cotangent(ranks):
    """make_view_variance over view=2 (float64): rank r warps source views
    2r and 2r + 1, the reference on rank 0 only, and its share of
    sum(volume * w) is 1 / |view| of it, as the train step's is. Each
    rank's features get the mean of the ranks' cotangents (collectives
    .shared over 'view'): half the one-process gradient on every view, the
    reference and the other rank's sources included, which sum_gradients'
    sum over the two ranks counts once. Without the sum a rank's would be
    the whole gradient on its own views and 0 on the others'. Bounds:
    1e-12 of the largest magnitude (float64 sums in another order)."""
    inp = ranks["inputs"]
    ref, src = (inp[k].clone().requires_grad_(True)
                for k in ("vs_ref", "vs_src"))
    with worker.float64_kept(torch.float64):
        volume = fused_variance_volume(ref, src, inp["vs_rel"],
                                       inp["vs_hyp"])
        g_ref, g_src = torch.autograd.grad((volume * inp["vs_w"]).sum(),
                                           (ref, src))
    got = [r[VIEW_SHARED] for r in ranks["results"]]
    assert [g["coords"]["view"] for g in got] == [0, 1]
    for g in got:
        for name, want, have in (("volume", volume.detach(), g["volume"]),
                                 ("ref", g_ref / 2, g["ref_grad"]),
                                 ("src", g_src / 2, g["src_grad"])):
            scale = float(want.abs().max())
            assert float((have - want).abs().max()) <= 1e-12 * scale, name
        # The other rank's source views and, on rank 1, the reference.
        other = slice(2, 4) if g["coords"]["view"] == 0 else slice(0, 2)
        assert float(g["src_grad"][:, other].abs().max()) > 0
        assert float(g["ref_grad"].abs().max()) > 0


# One bf16 rounding of a parameter's largest update: the farthest a view
# rank's bf16 update may lie from one bf16 process's.
BF16_ROUNDING = 2.0 ** -8


@pytest.mark.parametrize("mode", ["right", "unshared"])
def test_bf16_view_sharded_step_update_norm(ranks, mode):
    """bf16 MVSNet (f32 parameters, as cli train's), view=2, one source
    view a rank, against one bf16 process: the loss within 1e-3 and the
    update-norm ratio within 2% (chip_smoke.py 13b's limits), and every
    parameter's update within BF16_ROUNDING of its largest magnitude
    (here 1.1e-4: the partial sums' f32 order). With the features'
    cotangent not summed over the view group ('unshared', the fix
    reverted: each rank runs the feature net's backward in bf16 on its
    own view's share) the feature net's updates lie 0.226 of their
    largest magnitude away, 58x the limit, while the norm ratio, 1.0052
    at this size, stays inside 2% (0.978 at 13b's on an H100)."""
    want = ranks["single"][(1, "bfloat16", "mvsnet")]
    state = ranks["inputs"]["state"]
    want_upd = _updates(want, state)
    for rank in ranks["results"]:
        got = rank[("train", VIEW2, mode, 1, "bfloat16")]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-3)
        upd = _updates(got, state)
        assert _norm_ratio(upd, want_upd) == pytest.approx(1.0, rel=0.02)
        feature = {k for k in upd if k.startswith("MVSNetFeatureNet")}
        part = lambda keys: {k: want_upd[k] for k in keys}  # noqa: E731
        assert _deviation(upd, part(set(upd) - feature)) < BF16_ROUNDING
        off = _deviation(upd, part(feature))
        if mode == "right":
            assert off < BF16_ROUNDING
        else:
            assert off > 10 * BF16_ROUNDING

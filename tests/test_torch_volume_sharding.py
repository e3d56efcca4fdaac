"""The port's volume sharding (mvs_tpu_torch.parallel.sharding, .halo and
the reductions of .collectives) against mvs_tpu's volume_sharded_plan and
one process, on the CPU.

Ranks are real processes over gloo (tests/_torch_dist_worker.py, started by
parallel.launch_local, every rank killed when it ends); mvs_tpu runs on the
virtual CPU devices of tests/conftest.py. Bounds:
  * the guard: the same specs, folds and drops as mvs_tpu's
    ShardingPlan._guarded, exactly;
  * the halo exchange and every conv kind on slabs (float64): the slab of
    the whole volume's output and of its input gradient within 1e-12 of
    the largest magnitude, over gloo's all-reduce and over point-to-point
    sends (the NCCL path's logic);
  * the softmax and soft-argmin over a split D (float64): depth, confidence
    and probabilities within 1e-12 of one process's, against mvs_tpu's
    regression (float32) within 1e-5 of the largest magnitude;
  * MVSNet's eval forward over depth=2 x space=2 ranks (float32): the
    depth within 1e-3 of mvs_tpu's volume_sharded_plan forward on its
    virtual data=2 x depth=2 x space=2 mesh (mvs_tpu's own bound between
    that forward and its dense one, tests/test_parallel.py), and within
    1e-5 of the port's one process (only the sums' order differs);
  * one float64 train step (SGD) of CasMVSNet (48 / 32 / 8 hypotheses)
    over depth=2, space=2, depth=2 x space=2, data=2 x depth=2 and
    view=2 x space=2 ranks,
    and of MVSNet with RefineNet and OHEM over depth=2 x space=2: loss,
    update and BatchNorm statistics within 1e-9 of one process's; the
    shares of pixels past 2 / 4 / 8 mm, summed in f32, within 1e-6;
  * the wrong forms (no 1 / |depth| on the depth-split stages, a split
    volume's BatchNorm moments over 'data' only) off by more than 1e-3.
The cli train runs (mesh_depth=2 MVSNet, mesh_space=2 CasMVSNet) are
held to one process as tests/test_torch_parallel_cli.py holds its runs.
"""

import logging
import re
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mvs_tpu.models.mvsnet import MVSNet as JaxMVSNet
from mvs_tpu.ops.regression import regress_depth_and_confidence as \
    jax_regress
from mvs_tpu.parallel import make_mesh as jax_make_mesh
from mvs_tpu.parallel import replicate as jax_replicate
from mvs_tpu.parallel import shard_batch as jax_shard_batch
from mvs_tpu.parallel import sharding as jax_sharding
from mvs_tpu.parallel import volume_sharded_plan as jax_plan
from mvs_tpu_torch.cli import train as cli_train
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io.dtu import collate_mvsnet
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.nn.blocks import (Conv, ConvBlock, ConvTranspose,
                                     FusedConvBlock3D, init_random_)
from mvs_tpu_torch.ops.regression import regress_depth_and_confidence
from mvs_tpu_torch.parallel import launch_local, make_mesh
from mvs_tpu_torch.parallel import sharding
from mvs_tpu_torch.parallel.mesh import lines
from mvs_tpu_torch.parallel.sharding import guarded, slab_bounds
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_parallel import _mvsnet_batch
from test_torch_parallel import _deviation, _norm_ratio, run_ranks
from test_torch_parallel_cli import (CLI, _first_epoch_like_one_process,
                                     _resumed_like_one_process)
from test_torch_train import _train_batch as _cas_batch
from test_torch_train_blocks import random_variables
from test_torch_train_cli import _train_args

import _torch_dist_worker as worker

ROOT = Path(__file__).resolve().parents[1]
MESH = dict(data=2, view=1, depth=2, space=2)
VOLUME = ("data", "depth", "space", None, None)
SCORES = ("data", "depth", "space", None)
VIEWS = ("data", "view", "depth", "space", None, None)

D2, S2 = (("depth", 2),), (("space", 2),)
D2S2 = (("depth", 2), ("space", 2))
DATA2D2 = (("data", 2), ("depth", 2))
VIEW2S2 = (("view", 2), ("space", 2))
CAS_ND = (48, 32, 8)
CAS_CASES = [("train", D2, "right", 1, "float64", "cas"),
             ("train", S2, "right", 1, "float64", "cas"),
             ("train", D2, "no_copies_div", 1, "float64", "cas"),
             ("train", D2S2, "right", 1, "float64", "cas"),
             ("train", DATA2D2, "right", 1, "float64", "cas"),
             ("train", DATA2D2, "data_moments", 1, "float64", "cas"),
             ("train", VIEW2S2, "right", 1, "float64", "cas")]
MVS_CASE = ("train", D2S2, "right", 1, "float64", "mvsnet")
HALO_SPECS = {"depth_rows": VOLUME,
              "depth_4": ("data", ("depth", "space"), None, None, None),
              "rows_4": ("data", None, ("space", "depth"), None, None),
              "rows_cols": ("data", None, "depth", "space", None)}
HALO_CASES = [("halo", D2S2, name, p2p) for name in HALO_SPECS
              for p2p in (False, True)]
FWD_CASE = ("forward", D2S2, "float32")
NESTED_CASE = ("nested_shared", VIEW2S2)


# ---- the guard ------------------------------------------------------------------

def _axis_records(caplog, logger):
    return sorted((r.levelno, re.search(r"mesh axis '(\w+)'",
                                        r.getMessage()).group(1))
                  for r in caplog.records if r.name == logger)


def _both_guards(spec, shape, mesh_shape, levels, caplog):
    """(the port's spec, its (level, axis) records; mvs_tpu's, likewise),
    each package's one-time sets cleared first. The folds and drops that
    the port's guard returns are the axes of its records."""
    n = int(np.prod(list(mesh_shape.values())))
    jplan = jax_plan(jax_make_mesh(**mesh_shape, devices=jax.devices()[:n]))
    out, decided = [], None
    for fn, logger, sets in (
            (lambda: guarded(spec, shape, mesh_shape, levels),
             "mvs_tpu_torch.parallel.sharding",
             (sharding._warned_axes, sharding._folded_axes)),
            (lambda: tuple(jplan._guarded(P(*spec), shape, levels)),
             "mvs_tpu.parallel.sharding",
             (jax_sharding._warned_axes, jax_sharding._folded_axes))):
        for s in sets:
            s.clear()
        caplog.clear()
        with caplog.at_level(logging.INFO):
            got = fn()
        if decided is None:
            decided = sorted([(logging.INFO, a) for a, _ in got.folded]
                             + [(logging.WARNING, a) for a in got.dropped])
            got = got.spec
        out += [got, _axis_records(caplog, logger)]
    assert decided == out[1], (decided, out[1])
    return out


@pytest.mark.parametrize("name,spec,shape,levels,want", [
    ("small", VOLUME, (4, 16, 16, 16, 32), 3, ("data", None, None, None,
                                                None)),
    ("ok", VOLUME, (4, 32, 32, 32, 32), 3, ("data", "depth", "space", None,
                                             None)),
    ("mixed", VOLUME, (4, 48, 16, 16, 32), 3,
     ("data", ("depth", "space"), None, None, None)),
    ("stage3", VOLUME, (4, 8, 96, 64, 32), 3,
     ("data", None, ("space", "depth"), None, None)),
    ("scores", SCORES, (4, 16, 16, 16), 0, ("data", "depth", "space", None)),
])
def test_guard_matches_mvs_tpu(name, spec, shape, levels, want, caplog):
    """The cases of tests/test_parallel.py's guard test on a data=2 x
    depth=2 x space=2 mesh: the spec, and the same folds (info) and drops
    (warning, both axes for the small volume)."""
    got, logs, jgot, jlogs = _both_guards(spec, shape, MESH, levels, caplog)
    assert got == want == jgot
    assert logs == jlogs
    if name == "small":
        assert logs == [(logging.WARNING, "depth"), (logging.WARNING,
                                                     "space")]
    if name == "stage3":  # what cli train's rank 0 says of it
        said = cli_train.describe_layout(guarded(spec, shape, MESH, levels))
        assert said == ("spec ('data', None, ('space', 'depth'), None, "
                        "None) ('depth' folded into dim 2)")


def test_guard_sweep_matches_mvs_tpu(caplog):
    """A seeded sweep of meshes, shapes, specs and levels: the port's
    guard equals mvs_tpu's, records included."""
    rng = np.random.default_rng(0)
    meshes = [dict(data=a, view=b, depth=c, space=d)
              for a in (1, 2) for b in (1, 2) for c in (1, 2, 4)
              for d in (1, 2, 4) if a * b * c * d <= 8]
    extents = (8, 8, 16, 16, 24, 32, 40, 48, 64, 96, 192)
    folded = dropped = 0
    for _ in range(200):
        mesh = meshes[rng.integers(len(meshes))]
        spec = (VOLUME, SCORES, VIEWS)[rng.integers(3)]
        shape = (4,) + tuple(int(rng.choice(extents))
                             for _ in range(len(spec) - 2)) + (8,)
        levels = int(rng.choice([0, 3]))
        got, logs, jgot, jlogs = _both_guards(spec, shape, mesh, levels,
                                              caplog)
        assert got == jgot, (mesh, spec, shape, levels)
        assert logs == jlogs, (mesh, spec, shape, levels)
        folded += any(lv == logging.INFO for lv, _ in logs)
        dropped += any(lv == logging.WARNING for lv, _ in logs)
    assert folded > 5 and dropped > 5, (folded, dropped)


def test_slabs_are_aligned_units():
    """Every slab but none is empty, each a whole number of 8-plane units,
    the first ones one unit larger; the grid's lines over more than one
    axis put the first axis major."""
    for extent, n in ((48, 4), (40, 2), (32, 4), (192, 2), (8, 1)):
        bounds = [slab_bounds(extent, n, i) for i in range(n)]
        assert bounds[0][0] == 0 and bounds[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [b - a for a, b in bounds]
        assert all(s % 8 == 0 and s > 0 for s in sizes)
        assert sizes == sorted(sizes, reverse=True)
        assert max(sizes) - min(sizes) <= 8
    with pytest.raises(ValueError, match="does not split"):
        slab_bounds(16, 3, 0)
    assert lines((1, 1, 2, 2), ("space", "depth")) == [[0, 2, 1, 3]]
    assert lines((2, 1, 2, 1), ("data", "depth")) == [[0, 1, 2, 3]]


# ---- the ranks ------------------------------------------------------------------

def _halo_inputs():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 40, 32, 24, 3)))
    gen = torch.Generator().manual_seed(3)
    layers = {"stride1": Conv(3, 4, (3, 3, 3)),
              "stride2": Conv(3, 4, (3, 3, 3), stride=2, use_bias=False),
              "transposed": ConvTranspose(3, 4, stride=2),
              "score": Conv(3, 1, (3, 3, 3)),
              "fused_train": FusedConvBlock3D(3, 4),
              "fused_eval": FusedConvBlock3D(3, 4),
              "group": ConvBlock(3, 8, (3, 3, 3), normalization="group")}
    for m in layers.values():
        init_random_(m, gen)
        m.double()
    whole, grads, weights = {}, {}, {}
    for name, m in layers.items():
        train = name != "fused_eval"
        m.train(train)
        xg = x.clone().requires_grad_(True)
        with torch.set_grad_enabled(train), \
                worker.float64_kept(torch.float64):
            y = m(xg)
        w = torch.from_numpy(rng.normal(size=tuple(y.shape)))
        whole[name], weights[name] = y.detach(), w
        if train:
            (grads[name],) = torch.autograd.grad((y * w).sum(), xg)
    # Scores peaked around per-pixel centres in [20, 27): the 4-tap window
    # spans the 24 | 16 slab boundary of D = 40 on depth=2 at many pixels.
    d = np.arange(40)[None, :, None, None]
    centre = rng.uniform(20, 27, size=(1, 1, 32, 24))
    scores = torch.from_numpy(-(d - centre) ** 2 / 3.0
                              + rng.normal(0, 0.3, (1, 40, 32, 24)))
    hyp = torch.from_numpy(np.sort(rng.uniform(5, 15, (1, 40, 32, 24)),
                                   axis=1))
    ext_w = torch.from_numpy(rng.normal(size=(1, 40, 32, 24, 3)))
    weights["ext"] = ext_w
    return dict(halo_x=x, halo_layers=layers, halo_w=weights,
                halo_scale={"stride2": 0.5, "transposed": 2},
                halo_specs=HALO_SPECS, reg_scores=scores, reg_hyp=hyp,
                reg_w=torch.from_numpy(rng.normal(size=(1, 32, 24)))), \
        dict(whole=whole, grads=grads)


def _mvs_batch(size=128, depths=32):
    """2 plane scenes in the DTU training layout's form (as
    tests/test_torch_mvsnet_train.py's, larger): the (2, 32, 32, 32)
    volume keeps 'depth' on D and 'space' on H."""
    samples = []
    for seed in range(2):
        scene = make_plane_scene(num_views=3, height=size, width=size,
                                 z0=10.0, seed=seed, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = scene.depths[0][::4, ::4].astype(np.float32)
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_values=np.linspace(8.0, 12.0, depths, dtype=np.float32),
            depth_gt=gt, mask=(gt < 10.1).astype(np.float32)))
    return collate_mvsnet(samples)


def _fwd_inputs():
    """test_parallel.py's sharded-forward setting: MVSNet, 2 plane scenes
    at 64x64, 32 hypotheses; random trained-like variables."""
    batch = _mvsnet_batch(2, num_depth=32)
    jmodel = JaxMVSNet()
    variables = random_variables(jmodel, batch["imgs"],
                                 batch["proj_matrices"],
                                 batch["depth_values"], seed=5)
    return batch, jmodel, variables


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cli_started):
    """One launch of two gloo ranks and one of four for every rank case
    of this file (on threads of their own, beside the one-process runs
    and mvs_tpu's forward)."""
    cas_state = CasMVSNet(ndepths=CAS_ND, trained=False,
                          generator=torch.Generator().manual_seed(4)
                          ).state_dict()
    cas_batch = _cas_batch(64)
    cas_batch["mask"]["stage3"][1, :20] = 0.0  # unequal counts
    mvs_state = MVSNet(refine=True, trained=False,
                       generator=torch.Generator().manual_seed(6)
                       ).state_dict()
    mvs_batch = _mvs_batch()
    mvs_batch["mask"][1, :12] = 0.0
    halo_inp, halo_want = _halo_inputs()
    batch, jmodel, variables = _fwd_inputs()
    f64 = lambda st: {k: v.double() for k, v in st.items()}  # noqa: E731
    inputs = dict(state=f64(mvs_state), batch=mvs_batch, loss="ohem",
                  refine=True, cas_state=f64(cas_state), cas_batch=cas_batch,
                  cas_ndepths=CAS_ND, fwd_state=flax_to_state_dict(variables),
                  fwd_batch={k: np.asarray(v) for k, v in batch.items()},
                  **halo_inp)
    groups = {2: [], 4: [MVS_CASE, FWD_CASE, NESTED_CASE] + HALO_CASES}
    for case in CAS_CASES:
        groups[int(np.prod([n for _, n in case[1]]))].append(case)
    results = {}

    def launch(world):
        results[world] = run_ranks(
            dict(inputs, cases=groups[world]),
            tmp_path_factory.mktemp(f"w{world}"), world=world, timeout=120.0)

    threads = [threading.Thread(target=launch, args=(w,)) for w in groups]
    for t in threads:
        t.start()
    try:
        single = {
            "cas": worker.train(inputs, make_mesh(), "right", 1, "float64",
                                "cas"),
            "mvsnet": worker.train(inputs, make_mesh(), "right", 1,
                                   "float64", "mvsnet")}
        mesh = jax_make_mesh(**MESH, devices=jax.devices()[:8])
        model = JaxMVSNet(volume_constraint=jax_plan(mesh).constrain_volume)
        with jax.set_mesh(mesh):
            jax_out = jax.jit(lambda v, b: model.apply(
                v, b["imgs"], b["proj_matrices"], b["depth_values"]))(
                    jax_replicate(mesh, variables),
                    jax_shard_batch(mesh, batch))
        port = MVSNet()
        port.load_state_dict(inputs["fwd_state"])
        port.eval()
        with torch.no_grad():
            fb = {k: torch.from_numpy(v.copy()) for k, v in
                  inputs["fwd_batch"].items()}
            one = port(fb["imgs"], fb["proj_matrices"], fb["depth_values"])
    finally:
        for t in threads:
            t.join()
    assert set(results) == {2, 4}
    by_case = {}
    for world, rs in results.items():
        for case in groups[world]:
            by_case[case] = [r[case] for r in rs]
    return dict(inputs=inputs, cases=by_case, single=single,
                halo=halo_want, jax_depth=np.asarray(jax_out["depth"]),
                one_depth=one["depth"].numpy())


# ---- halo exchange, convs on slabs, the split softmax -------------------------

def _close(got, want, rel=1e-12):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale, (
        float((got - want).abs().max()), scale)


@pytest.mark.parametrize("case", HALO_CASES, ids=lambda c: f"{c[2]}-"
                         f"{'p2p' if c[3] else 'slots'}")
def test_halo_exchange_and_convs_on_slabs(ranks, case):
    inp, want = ranks["inputs"], ranks["halo"]
    x = inp["halo_x"]
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    ext_grads = torch.zeros_like(x)
    split_dims = {d for d, e in enumerate(HALO_SPECS[case[2]]) if e
                  and e != "data"}
    for r in ranks["cases"][case]:
        index = r["slices"]
        # The extended slab: the whole volume's planes around the slab,
        # zeros past its ends, on the split dims only.
        ext_index = tuple(
            slice(None) if d == 0 or d == 4 else
            slice(index[d].start, index[d].stop + 2) if d in split_dims
            else slice(1, -1) for d in range(5))
        _close(r["ext"], pad[ext_index])
        ext_grads[index] += r["ext_grad"]
        for name, y in want["whole"].items():
            scale = inp["halo_scale"].get(name, 1)
            out = worker._scaled(index, scale)
            _close(r[name], y[out])
            if name in want["grads"]:
                _close(r[name + "_grad"], want["grads"][name][index])
    # The halo's cotangents went back to their owners: every slab's
    # gradient of sum(ext * w) is the whole's.
    wp = torch.nn.functional.pad(inp["halo_w"]["ext"].clone(),
                                 (0, 0, 1, 1, 1, 1, 1, 1))
    xg = x.clone().requires_grad_(True)
    total = 0
    for r in ranks["cases"][case]:
        index = r["slices"]
        ext_index = tuple(
            slice(None) if d == 0 or d == 4 else
            slice(index[d].start, index[d].stop + 2) if d in split_dims
            else slice(1, -1) for d in range(5))
        xp = torch.nn.functional.pad(xg, (0, 0, 1, 1, 1, 1, 1, 1))
        total = total + (xp[ext_index] * wp[ext_index]).sum()
    (g,) = torch.autograd.grad(total, xg)
    _close(ext_grads, g)


def test_shared_features_take_the_groups_cotangent(ranks):
    """collectives.shared: every rank of a depth=2 x space=2 sample group
    holds the features alike and gets the mean of the ranks' cotangents
    (rank r's (r + 1) x), so that sum_gradients' sum counts their backward
    once."""
    x = ranks["inputs"]["halo_x"]
    got = [r["shared_grad"] for r in ranks["cases"][HALO_CASES[0]]]
    assert len(got) == 4
    for g in got:
        assert float((g - 2.5 * x).abs().max()) <= 1e-12 * float(
            x.abs().max())


def test_nested_shared_takes_the_product_groups_cotangent(ranks):
    """shared over 'view' inside shared over the sample group (space), as
    make_view_variance's sits inside the models' on a view=2 x space=2
    mesh: the groups are orthogonal, so every rank gets the mean over all
    four ranks' cotangents (rank r's (r + 1) x): 2.5 x."""
    x = ranks["inputs"]["halo_x"]
    got = [r["grad"] for r in ranks["cases"][NESTED_CASE]]
    assert len(got) == 4
    for g in got:
        assert float((g - 2.5 * x).abs().max()) <= 1e-12 * float(
            x.abs().max())


@pytest.mark.parametrize("spec", ["depth_rows", "depth_4"])
def test_split_softmax_matches_mvs_tpu(ranks, spec):
    """The softmax, soft-argmin and 4-tap confidence over D split 24 | 16
    (depth_rows) or 16 | 8 | 8 | 8 (depth_4) against one process and
    mvs_tpu's regression, with windows that span two slabs; the scores'
    gradient of the ranks' shares of sum(depth * w) against one
    process's."""
    inp = ranks["inputs"]
    scores = inp["reg_scores"].clone().requires_grad_(True)
    depth, conf, prob = regress_depth_and_confidence(scores, inp["reg_hyp"])
    (grad,) = torch.autograd.grad((depth * inp["reg_w"]).sum(), scores)
    jd, jc, jp = jax.vmap(jax_regress)(
        jnp.asarray(inp["reg_scores"].numpy(), jnp.float32),
        jnp.asarray(inp["reg_hyp"].numpy(), jnp.float32))
    index = np.asarray(jax.vmap(lambda p: jnp.sum(
        p * jnp.arange(40.0)[:, None, None], axis=0))(jp)).astype(int)
    bounds = [24] if spec == "depth_rows" else [16, 24, 32]
    spans = sum(int(((index - 1 < b) & (index + 2 >= b)).sum())
                for b in bounds)
    assert spans > 50, spans
    case = ("halo", D2S2, spec, False)
    grads = torch.zeros_like(grad)
    for r in ranks["cases"][case]:
        reg, index5 = r["regress"], r["slices"]
        rows = (slice(None), reg["rows"], reg["cols"])
        _close(reg["depth"], depth.detach()[rows])
        _close(reg["conf"], conf[rows])
        _close(reg["prob"], prob.detach()[index5[:4]])
        grads[index5[:4]] += reg["grad"]
        for got, want in ((reg["depth"], jd), (reg["conf"], jc)):
            want = torch.from_numpy(np.asarray(want, np.float64))[rows]
            _close(got, want, 1e-5)
    _close(grads, grad)


# ---- MVSNet's forward ---------------------------------------------------------

def test_mvsnet_forward_matches_volume_sharded_plan(ranks):
    """Four ranks split the (2, 32, 16, 16) volume's D over ('depth',
    'space') as mvs_tpu's guard folds it: each holds the whole maps."""
    for r in ranks["cases"][FWD_CASE]:
        assert r["rows"] == slice(None) and r["cols"] == slice(None)
        got = r["depth"].numpy()
        np.testing.assert_allclose(got, ranks["jax_depth"], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(got, ranks["one_depth"], rtol=0,
                                   atol=1e-5)


# ---- the float64 train steps --------------------------------------------------

def _updates(result, state):
    """Each parameter's update; every parameter here takes a gradient (the
    score bias's is exactly 0: the softmax over depth is invariant to it,
    so both sides hold rounding residue of the same size)."""
    return {k: result["state"][k].double() - state[k].double()
            for k in state if not k.endswith(("mean", "var", "count"))
            and not k.endswith("FoldedConv_0.bias")}


def _check_step(got, want, state):
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-9)
    for k, v in want["metrics"].items():
        rtol = 1e-6 if k.startswith("thres") else 1e-9
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                   atol=1e-12)
    assert _deviation(_updates(got, state), _updates(want, state)) < 1e-9
    for k in want["state"]:
        if k.endswith(("mean", "var")):
            torch.testing.assert_close(got["state"][k], want["state"][k],
                                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", [c for c in CAS_CASES if c[2] == "right"],
                         ids=lambda c: "x".join(f"{a}{n}" for a, n in c[1]))
def test_cas_train_step_equals_one_process(ranks, case):
    """CasMVSNet at 64x64: stage 1 (48, 16, 16) splits D (over 'depth',
    or 'space' folded into D, or both), stage 2 (32, 32, 32) D and H,
    stage 3 (8, 64, 64) folds 'depth' into H; with 'view', each view rank
    builds its slab from its own source view's partial sums."""
    want = ranks["single"]["cas"]
    for got in ranks["cases"][case]:
        _check_step(got, want, ranks["inputs"]["cas_state"])


def test_mvsnet_refine_ohem_step_equals_one_process(ranks):
    """MVSNet at 128x128 (the (2, 32, 32, 32) volume's D over 'depth', H
    over 'space': the two ranks of a depth line hold the same rows) with
    RefineNet on the gathered depth and OHEM ranking the gathered global
    map."""
    want = ranks["single"]["mvsnet"]
    for got in ranks["cases"][MVS_CASE]:
        _check_step(got, want, ranks["inputs"]["state"])


@pytest.mark.parametrize("case,what", [
    (CAS_CASES[2], "no 1 / |depth|"), (CAS_CASES[5], "moments over data")])
def test_wrong_volume_rules_fail(ranks, case, what):
    """Each wrong form moves the update by more than 1e-3: without the
    1 / |depth| the depth-split stages' gradients double; BatchNorm's
    moments over 'data' only normalize each slab by its own."""
    state = ranks["inputs"]["cas_state"]
    want = _updates(ranks["single"]["cas"], state)
    for r in ranks["cases"][case]:
        got = _updates(r, state)
        assert _deviation(got, want) > 1e-3, what
        if case[2] == "no_copies_div":
            assert _norm_ratio(got, want) > 1.2


# ---- cli train (started first, run beside the rank cases) -------------------

@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    from mvs_tpu_torch.utils.make_synthetic_dtu import generate

    return generate(tmp_path_factory.mktemp("vdtu") / "dtu", num_scans=2,
                    num_views=3, height=64, width=64, num_depth=32,
                    num_lights=2, tilt=(0.05, 0.02))


def _cli_args(root, log_dir, *extra):
    return ["data.batch_size=2" if a == "data.batch_size=3" else
            "data.num_depth=32" if a == "data.num_depth=16" else a
            for a in _train_args(root, log_dir, "train.optimizer=sgd",
                                 *extra)]


CLI_MESHES = {"depth": (("model.name=mvsnet",), "train.mesh_depth=2"),
              "space": ((), "train.mesh_space=2")}
EPOCHS = (("train.epochs=1",), ("train.epochs=2", "--resume"))


@pytest.fixture(scope="module")
def cli_started(cli_root, tmp_path_factory):
    """The cli train runs on threads of their own: for each of CLI_MESHES
    two ranks (an epoch, then --resume for a second), and one process
    running both meshes' epochs. Returns join() -> the runs."""
    import os

    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    dirs = {m: [tmp_path_factory.mktemp(f"{m}_{n}") for n in ("two", "one")]
            for m in CLI_MESHES}
    outs = {m: [] for m in CLI_MESHES}
    want, errors = {}, []

    def guarded(fn):
        def run(*a):
            try:
                fn(*a)
            except BaseException as e:  # noqa: BLE001 - re-raised on join
                errors.append(e)
        return run

    @guarded
    def two(m):
        for extra in EPOCHS:
            argv = [sys.executable, "-c", CLI, "train",
                    *_cli_args(cli_root, dirs[m][0], *CLI_MESHES[m][0],
                               CLI_MESHES[m][1], *extra)]
            env = dict(os.environ, OMP_NUM_THREADS="2")
            got = launch_local(argv, 2, timeout=150.0, cwd=ROOT, env=env)
            for r, (rc, out) in enumerate(got):
                assert rc == 0, f"rank {r} exited {rc}:\n{out[-3000:]}"
            outs[m].append([out for _, out in got])

    @guarded
    def one():
        for m in CLI_MESHES:
            want[m] = [cli_train.main(_cli_args(cli_root, dirs[m][1],
                                                *CLI_MESHES[m][0], *extra))
                       for extra in EPOCHS]

    threads = [threading.Thread(target=two, args=(m,)) for m in CLI_MESHES]
    threads.append(threading.Thread(target=one))
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        mp.undo()
        if errors:
            raise errors[0]
        return {m: dict(two=dirs[m][0], outs=outs[m], want=want[m])
                for m in CLI_MESHES}

    yield join
    for t in threads:
        t.join()


@pytest.fixture(scope="module")
def cli_runs(cli_started, ranks):
    return cli_started()


@pytest.mark.parametrize("mesh,line", [
    ("depth", "volumes (B, 32, 16, 16, C): spec (None, 'depth', None, "
     "None, None)"),
    ("space", "volumes (B, 8, 16, 16, C): spec (None, None, None, None, "
     "None) ('space' dropped)")])
def test_cli_trains_split_volumes_like_one_process(cli_runs, mesh, line):
    """mesh_depth=2 (MVSNet, D = 32 split) and mesh_space=2 (CasMVSNet:
    stages 2 and 3 split their rows, stage 1's 16 rows cannot take the
    axis and D = 8 cannot absorb it, so 'space' is dropped there, said
    once): an epoch as one process's, rank 0 saying the layouts, then a
    checkpoint and --resume."""
    run = cli_runs[mesh]
    first = run["outs"][0][0]
    assert line in first, first[:3000]
    _first_epoch_like_one_process(run, f"mesh {{'data': 1, 'view': 1, "
                                  f"'depth': {2 if mesh == 'depth' else 1}, "
                                  f"'space': {2 if mesh == 'space' else 1}}}")
    _resumed_like_one_process(run)

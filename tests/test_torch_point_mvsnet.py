"""The port's Point-MVSNet against mvs_tpu's on the CPU, f32: each network
of nn/point_nets.py in eval and train mode, the whole model coarse-only and
with the untiled flow (the tiled sub-flow: tests/test_torch_point_subflow.py,
so that each file runs alone in under a minute), the parameter tree of a
coarse-only init, the registry and `cli infer`.

Variables are drawn in the Flax layout from a seed with non-trivial
BatchNorm (``flax_variables``: the tree is the port's, which
test_use_flow_false_init_has_the_port_tree holds against jax.eval_shape of
mvs_tpu's init, so no JAX init is compiled) and carried over by
convert.flax_to_state_dict.

Tolerances. Networks: outputs rtol / atol 2e-4 (f32 sums in another
order, as tests/test_torch_blocks.py); in train mode the new statistics
rtol 1e-5 / atol 1e-6 and each gradient within 1e-4 of its largest
magnitude (as tests/test_torch_train_blocks.py). Whole model: the coarse
volume comes from the kernel route (composed projections, plain version
here) where mvs_tpu unprojects and fetches, so the coarse depth moves by a
few f32 ulps (limit 1e-5 of a depth near 10, 4e-5 of an interval) and the
probability map by 1e-6. The flow's xyz inherit those ulps, and on the
regular hypothesis lattice some points have neighbours at nearly equal
distances, so an ulp can swap the 16th and 17th nearest: at 64x80 the kNN
sets of 0.6-0.8% of the points differ (on the tiled sub-lattices, where
the ladder's pure-depth neighbours tie at the cut, up to 14%), and
through three EdgeConvs (three hops of the graph) that moves flow depths
by up to 2% of an interval. So the comparison is split: the port's
lattices lie within 2e-5 of mvs_tpu's, its lattice_knn gives on them
exactly what mvs_tpu's gives, and then the port runs on mvs_tpu's graphs
(``run_on_jax_graphs``): its flow depths agree within 1e-5 and its
probabilities within 2e-5 (the ulps of the inputs, through random
weights, move them by up to 4e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.models.point_mvsnet import PointMVSNet as JaxPointMVSNet
from mvs_tpu.nn import point_nets as jax_nets
from mvs_tpu.ops.point_ops import lattice_knn as jax_knn
from mvs_tpu.utils.synthetic import make_plane_scene
from mvs_tpu_torch.cli import infer
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io import read_pfm
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.nn import point_nets
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate

H, W, VIEWS, NUM_DEPTH = 64, 80, 3, 16
DEPTH_START, DEPTH_INTERVAL = 8.0, 4.0 / 15
GRAD_TOL = 1e-4


def flax_variables(module: torch.nn.Module, seed: int, count: float = 3.0):
    """Flax variables for the port `module`'s tree, drawn from `seed`:
    kernels N(0, 1/fan_in) in the Flax layout (HWIO / DHWIO, Dense (in,
    out)), BatchNorm scale U(0.5, 1.5), bias N(0, 0.2), and the
    zero-started accumulators of `count` updates toward mean N(0, 0.1) and
    var U(0.2, 0.6) (0 at count 0, as Flax's init leaves them)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    debias = 1.0 - 0.9 ** count
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf == "kernel":
            if len(shape) == 2:
                shape = shape[::-1]
            elif path[-1].startswith("ConvTranspose"):
                shape = (*shape[2:], shape[0], shape[1])
            else:
                shape = (*shape[2:], shape[1], shape[0])
            value = rng.normal(0.0, 1.0, shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("mean", "var", "count"):
            value = {"mean": lambda: rng.normal(0.0, 0.1, shape) * debias,
                     "var": lambda: rng.uniform(0.2, 0.6, shape) * debias,
                     "count": lambda: np.full(shape, count)}[leaf]()
        else:
            value = {"scale": lambda: rng.uniform(0.5, 1.5, shape),
                     "bias": lambda: rng.normal(0.0, 0.2, shape)}[leaf]()
        node = tree.setdefault(
            "batch_stats" if leaf in ("mean", "var", "count") else "params",
            {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)
    return tree


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(variables))
    return module


def _check_stats(port: torch.nn.Module, variables, new_stats):
    want = flax_to_state_dict({"params": variables["params"],
                               "batch_stats": new_stats})
    got = port.state_dict()
    keys = [k for k in want if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                         "count")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _knn_graph(seed, b=2, gh=3, gw=4):
    xyz = np.random.default_rng(seed).standard_normal(
        (b, 3, 5, gh, gw)).astype(np.float32)
    return np.stack([np.asarray(jax_knn(jnp.asarray(x), 5, 16))
                     for x in xyz])


def _network(name):
    """(JAX module, port module, inputs) of a network of point_nets."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 60, 20)).astype(np.float32)
    if name == "image_conv":
        img = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
        return jax_nets.ImageConv(4), point_nets.ImageConv(4), (img,)
    if name == "volume_conv":
        # 16 x 12 x 14 voxels: 4 x 3 x 4 at 1/4 and 8 x 6 x 7 at 1/2, so
        # the upsamples are cropped; batch 2, 16 voxels at 1/8 for the
        # BatchNorm of train mode.
        vol = rng.standard_normal((2, 16, 12, 14, 16)).astype(np.float32)
        return jax_nets.VolumeConv(4), point_nets.VolumeConv(16, 4), (vol,)
    if name == "shared_mlp":
        return (jax_nets.SharedMLP((12, 6)), point_nets.SharedMLP(20, (12, 6)),
                (pts,))
    concat = name == "edge_conv"
    return (jax_nets.EdgeConv(8, concat_central=concat),
            point_nets.EdgeConv(20, 8, concat_central=concat),
            (pts, _knn_graph(1)))


NETWORKS = ("image_conv", "volume_conv", "edge_conv", "edge_conv_no_concat",
            "shared_mlp")


def _tensors(inputs):
    return [torch.tensor(x) for x in inputs]


def _flat(out):
    if not isinstance(out, dict):
        out = {"out": out}
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", NETWORKS)
def test_network_eval_matches_jax(name):
    jmod, port, inputs = _network(name)
    variables = flax_variables(port, seed=2)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        variables, *map(jnp.asarray, inputs))
    load_flax(port, variables).eval()
    with torch.no_grad():
        got = _flat(port(*_tensors(inputs)))
    want = _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", NETWORKS)
def test_network_train_matches_jax(name):
    """Train mode: outputs, the gradients of sum(out * w) (parameters and
    the float input) and the statistics after the update, from count 3."""
    jmod, port, inputs = _network(name)
    variables = flax_variables(port, seed=3)
    rng = np.random.default_rng(4)

    def first(out):
        return out["conv3"] if isinstance(out, dict) else out

    def loss(params, x, w):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": variables["batch_stats"]}, x,
                              *map(jnp.asarray, inputs[1:]), train=True,
                              mutable=["batch_stats"])
        y = first(out)
        return jnp.sum(y * w), (y, upd["batch_stats"])

    y_shape = first(jax.eval_shape(
        lambda: jmod.apply(variables, *map(jnp.asarray, inputs))))
    w = rng.standard_normal(y_shape.shape).astype(np.float32)
    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(inputs[0]), jnp.asarray(w))

    load_flax(port, variables).train()
    x = torch.tensor(inputs[0], requires_grad=True)
    out = first(port(x, *_tensors(inputs[1:])))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=2e-4, atol=2e-4)
    want_grads = flax_to_state_dict({"params": jax.tree.map(np.asarray, gp)})
    grads = dict(port.named_parameters())
    assert set(want_grads) == set(grads)
    for k, g in want_grads.items():
        err = (grads[k].grad - g).abs().max() / g.abs().max()
        assert err <= GRAD_TOL, (k, float(err))
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0,
                               atol=GRAD_TOL * np.abs(gx).max())
    _check_stats(port, variables, jax.tree.map(np.asarray, stats))


@pytest.fixture(scope="module")
def scene():
    s = make_plane_scene(num_views=VIEWS, height=H, width=W, z0=10.0,
                         tilt=(0.05, 0.02))
    inputs = (s.images[None], s.intrinsics[None], s.extrinsics[None],
              np.array([DEPTH_START], np.float32),
              np.array([DEPTH_INTERVAL], np.float32))
    return [np.asarray(x, np.float32) for x in inputs]


@pytest.fixture(scope="module")
def variables():
    return flax_variables(PointMVSNet(), seed=5)


def jax_graphs(fn):
    """fn() run with mvs_tpu's lattice_knn recording each lattice and graph
    it builds, a sample at a time (the model's vmap over the batch calls
    the callback once per sample; XLA may run independent calls, as the
    sub-lattices', in any order) -> (fn's result, [(xyz (1, 3, D, H, W),
    graph (1, N, k))])."""
    import mvs_tpu.models.point_mvsnet as jax_model

    graphs, knn = [], jax_model.lattice_knn

    def recording(xyz, kernel_size, k):
        idx = knn(xyz, kernel_size=kernel_size, k=k)
        jax.debug.callback(lambda x, i: graphs.append(
            (np.asarray(x).reshape(-1, *x.shape[-4:]),
             np.asarray(i).reshape(-1, *i.shape[-2:]))), xyz, idx)
        return idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "lattice_knn", recording)
        out = jax.block_until_ready(fn())
    return out, graphs


def run_on_jax_graphs(fn, graphs, xyz_atol=2e-5, check_knn=True):
    """fn() with the port's model taking mvs_tpu's graphs for its own: for
    each sample of each lattice the port builds, the recorded lattice
    nearest to it, which must lie within `xyz_atol` (2e-5 at a depth near
    10: a few ulps of f32 against f32); the port's lattice_knn on its
    lattice must give exactly what mvs_tpu's gives on it (eager: XLA's
    fused kNN rounds some distances otherwise; `check_knn`). So a graph of
    the port's differs from mvs_tpu's only where those ulps decide a near
    tie. Returns (fn's result, the share of points whose neighbour sets
    the two graphs agree on, per lattice)."""
    import mvs_tpu_torch.models.point_mvsnet as port_model

    shares, unused, knn = [], list(range(len(graphs))), \
        port_model.lattice_knn

    def nearest(x):
        same = [i for i in unused if graphs[i][0].shape[1:] == x.shape]
        i = min(same, key=lambda i: np.abs(graphs[i][0][0] - x).max())
        np.testing.assert_allclose(x, graphs[i][0][0], rtol=0,
                                   atol=xyz_atol)
        unused.remove(i)
        return graphs[i][1][0]

    def substitute(xyz, kernel_size, k):
        got_xyz = xyz.detach().numpy()
        want = np.stack([nearest(x) for x in got_xyz])
        own = knn(xyz, kernel_size=kernel_size, k=k).numpy()
        for i, x in enumerate(got_xyz if check_knn else ()):
            np.testing.assert_array_equal(own[i], np.asarray(jax_knn(
                jnp.asarray(x), kernel_size, k)))
        shares.append(float((np.sort(own, -1) == np.sort(want, -1))
                            .all(-1).mean()))
        return torch.as_tensor(want, dtype=torch.int64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_model, "lattice_knn", substitute)
        out = fn()
    assert not unused
    return out, shares


def check_flow(got, want, iteration, interval):
    """Flow depth within 1e-5 (1e-4 of the finer interval, 0.1) and
    probabilities within 2e-5, on the same graphs."""
    np.testing.assert_allclose(got[f"flow{iteration}"],
                               want[f"flow{iteration}"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[f"flow{iteration}_prob"],
                               want[f"flow{iteration}_prob"], rtol=0,
                               atol=2e-5)


def check_coarse(got, want):
    np.testing.assert_allclose(got["coarse_depth"], want["coarse_depth"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["coarse_prob_map"],
                               want["coarse_prob_map"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["world_points"], want["world_points"],
                               rtol=0, atol=1e-5)


def test_coarse_only_matches_jax(scene, variables):
    want = jax.jit(lambda v, *a: JaxPointMVSNet().apply(
        v, *a, num_depth=NUM_DEPTH, use_flow=False))(
            variables, *map(jnp.asarray, scene))
    want = {k: np.asarray(v) for k, v in want.items()}
    model = load_flax(PointMVSNet(num_depth=NUM_DEPTH), variables).eval()
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(*_tensors(scene),
                                              use_flow=False).items()}
    assert set(got) == set(want) == {"coarse_depth", "coarse_prob_map",
                                     "world_points", "depth"}
    check_coarse(got, want)
    np.testing.assert_array_equal(got["depth"], got["coarse_depth"])
    assert got["coarse_depth"].shape == (1, H // 8, W // 8)


def run_point_model(variables, scene, **kwargs):
    """mvs_tpu's outputs and the port's (on mvs_tpu's graphs), eval mode."""
    want, graphs = jax_graphs(lambda: jax.jit(
        lambda v, *a: JaxPointMVSNet(**kwargs).apply(
            v, *a, num_depth=NUM_DEPTH))(variables, *map(jnp.asarray, scene)))
    model = load_flax(PointMVSNet(num_depth=NUM_DEPTH, **kwargs),
                      variables).eval()
    with torch.no_grad():
        got, shares = run_on_jax_graphs(lambda: model(*_tensors(scene)),
                                        graphs)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, shares)


def test_flow_matches_jax(scene, variables):
    """Two flow iterations, untiled: every output of mvs_tpu's model. The
    port's own graphs agree with mvs_tpu's at 99% of the points or more."""
    got, want, shares = run_point_model(variables, scene)
    assert len(shares) == 2 and min(shares) >= 0.99, shares
    assert set(got) == set(want)
    check_coarse(got, want)
    for it, (scale, inter) in enumerate(((0.25, 0.75), (0.5, 0.375))):
        assert got[f"flow{it + 1}"].shape == (1, int(H * scale),
                                              int(W * scale))
        check_flow(got, want, it + 1, inter * DEPTH_INTERVAL)
    np.testing.assert_array_equal(got["depth"], got["flow2"])


def test_use_flow_false_init_has_the_port_tree(scene):
    """mvs_tpu's init without the flow still creates every flow module
    (the coarse stage trains first on the same tree): its tree and shapes
    are the port's, which flax_variables draws."""
    shapes = jax.eval_shape(lambda: JaxPointMVSNet().init(
        jax.random.key(0), *map(jnp.asarray, scene), num_depth=NUM_DEPTH,
        use_flow=False))
    want = {"/".join(str(k.key) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {"/".join(str(k.key) for k in path): tuple(np.shape(x))
           for path, x in jax.tree_util.tree_leaves_with_path(
               flax_variables(PointMVSNet(), seed=0))}
    assert got == want
    assert any(k.startswith("params/edge_conv2/") for k in want)


def test_registry_builds_point_mvsnet_and_refuses_bf16():
    cfg = load_config(None, ["model.name=point_mvsnet",
                             "model.base_channels=4",
                             "model.num_depth_coarse=24",
                             "model.flow_sub_stride=2",
                             "model.flow_scales=0.5",
                             "model.inter_scales=0.5"])
    model = build_model(cfg)
    assert isinstance(model, PointMVSNet) and model.family == "point"
    assert (model.num_depth, model.flow_sub_stride, model.flow_scales,
            model.inter_scales) == (24, 2, (0.5,), (0.5,))
    assert model.coarse_img_conv.Conv_0.kernel.shape[0] == 32
    with pytest.raises(ValueError, match="float32 only"):
        build_model(load_config(None, ["model.name=point_mvsnet",
                                       "model.compute_dtype=bfloat16"]))


def test_cli_infer_point_mvsnet(tmp_path):
    """`infer` with model.name=point_mvsnet: depth at half the images'
    resolution, the coarse probability map at 1/8 as the confidence, each
    map what make_apply_fn gives for the sample; then `fuse` over them."""
    from mvs_tpu_torch.cli import fuse

    root = generate(tmp_path / "dtu", num_scans=1, num_views=4, height=64,
                    width=96, num_depth=16, tilt=(0.05, 0.02),
                    train_layout=False)
    overrides = ["model.name=point_mvsnet", "model.num_depth_coarse=16",
                 f"data.eval_root={root}",
                 f"data.eval_list={root / 'lists' / 'test.txt'}",
                 "data.num_views=3", "data.num_depth=16", "data.max_h=64",
                 "data.max_w=96", "data.align=32", "data.batch_size=3"]
    cfg = load_config(None, overrides)
    model = build_model(cfg)
    torch.save(model.state_dict(), tmp_path / "point.pt")
    result = infer.main(["--ckpt", str(tmp_path / "point.pt"), "--out",
                         str(tmp_path / "out"), "--device", "cpu",
                         *overrides])
    assert result["maps"] == 4
    depth = read_pfm(tmp_path / "out" / "scan1" / "depth_est" /
                     "00000001.pfm")[0]
    conf = read_pfm(tmp_path / "out" / "scan1" / "confidence" /
                    "00000001.pfm")[0]
    assert depth.shape == (32, 48) and conf.shape == (8, 12)
    from mvs_tpu_torch.io.dtu import DTUEvalDataset
    ds = DTUEvalDataset(root, ["scan1"], num_views=3, num_depth=16,
                        max_h=64, max_w=96, align=32)
    apply_fn = infer.make_apply_fn(model, "cpu",
                                   **infer.model_static_kwargs(cfg))
    # The CLI's first batch: views 0-2.
    d, c = apply_fn(*infer.stack_model_inputs([ds[i] for i in range(3)],
                                              "cpu", "point"))
    np.testing.assert_array_equal(depth, d[1].numpy())
    np.testing.assert_array_equal(conf, c[1].numpy())
    ply = fuse.main(["--out", str(tmp_path / "out"), "--device", "cpu",
                     f"data.eval_root={root}", "fusion.conf_thresh=0.0",
                     "fusion.num_consistent=1"])[0]
    assert ply.exists()

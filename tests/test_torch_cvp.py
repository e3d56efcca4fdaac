"""The port's CVP-MVSNet inference and the modules it adds, against
mvs_tpu's on the CPU (JAX_PLATFORMS=cpu, exact gather sampler).

Module by module at f32, on numpy inputs from a seed: the depth helpers and
the epipolar interval to rtol 1e-5; both resizes against jax.image.resize
to 1e-6 of the largest magnitude (the cubic weights pinned against
jax.image's own weight matrix); the stride-1 transposed block, AttentionConv,
PyramidFeatureNet and PyramidCostRegNet with converted weights and
non-trivial BatchNorm statistics to atol 1e-4. The whole model (3 levels at
64x80, 3 views, batch 2, epipolar interval on, Flax parameters through
convert.py) to the CasMVSNet bounds of tests/test_torch_cas_mvsnet.py:
depth rtol 1e-4 at every level, confidence atol 1e-4. The reference's size
limit (an odd level in PyramidCostRegNet) is pinned on both sides, and
`cli infer --config configs/cvp_eval_dtu.yaml` runs on the CPU on the
port's synthetic fixture. AACVP-MVSNet is in
tests/test_torch_group_correlation.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from mvs_tpu.geometry import depth as jdepth
from mvs_tpu.geometry.projection import scale_intrinsics as jax_scale_k
from mvs_tpu.models.cvp_mvsnet import CVPMVSNet as JaxCVPMVSNet
from mvs_tpu.nn import blocks as jblocks
from mvs_tpu.nn.cost_reg import PyramidCostRegNet as JaxPyramidCostRegNet
from mvs_tpu.nn.feature_nets import AttentionConv as JaxAttentionConv
from mvs_tpu.nn.feature_nets import PyramidFeatureNet as JaxFeatureNet
from mvs_tpu_torch.cli import infer
from mvs_tpu_torch.cli.infer import make_apply_fn, stack_model_inputs
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.geometry import depth
from mvs_tpu_torch.geometry.resize import (cubic_weight_matrix,
                                           downsample_bilinear, resize_cubic)
from mvs_tpu_torch.io import read_cam_file, read_pfm
from mvs_tpu_torch.io.dtu import DTUEvalDataset, _scale_to_fit
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.nn.blocks import ConvTransposeBlock
from mvs_tpu_torch.nn.cost_reg import PyramidCostRegNet
from mvs_tpu_torch.nn.feature_nets import AttentionConv, PyramidFeatureNet
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_blocks import perturb_batch_norm

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "cvp_eval_dtu.yaml"


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def init_variables(module, *args, seed=0):
    """Flax variables of `module` from numpy, with the tree of
    jax.eval_shape(module.init) (no compile): kernels and embeddings
    N(0, 1/fan_in), then non-trivial BatchNorm and biases
    (perturb_batch_norm)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    rng = np.random.default_rng(seed)
    return perturb_batch_norm(jax.tree.map(
        lambda x: (rng.normal(0.0, 1.0, x.shape)
                   / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        if len(x.shape) > 1 else np.zeros(x.shape, np.float32), shapes),
        seed + 1)


def run_both(jax_module, port_module, x, seed=0):
    """(port output, JAX output, the JAX variables) of one module in eval
    mode, the port holding the converted weights."""
    variables = init_variables(jax_module, jnp.asarray(x), seed=seed)
    want = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
    port_module.load_state_dict(flax_to_state_dict(variables))
    port_module.eval()
    with torch.no_grad():
        got = port_module(_t(x))
    return got.numpy(), np.asarray(want), variables


def scenes(batch, height, width, views=3):
    """`batch` tilted plane scenes as numpy arrays stacked on a batch axis."""
    out = [make_plane_scene(num_views=views, height=height, width=width,
                            z0=10.0, seed=i, tilt=(0.05, 0.02))
           for i in range(batch)]
    return {k: np.stack([getattr(s, k) for s in out])
            for k in ("images", "intrinsics", "extrinsics", "depths")}


def test_uniform_and_residual_hypotheses():
    rng = np.random.default_rng(0)
    dmin = rng.uniform(400, 500, 2).astype(np.float32)
    iv = rng.uniform(2, 3, 2).astype(np.float32)
    want = jax.vmap(lambda a, b: jdepth.uniform_depth_values(a, b, 48))(
        dmin, iv)
    np.testing.assert_allclose(
        depth.uniform_depth_values(_t(dmin), _t(iv), 48).numpy(), want,
        rtol=1e-5)
    cur = rng.uniform(400, 900, (2, 6, 7)).astype(np.float32)
    want = jax.vmap(lambda d, i: jdepth.residual_depth_hypotheses(d, i, 4))(
        cur, iv)
    got = depth.residual_depth_hypotheses(_t(cur), _t(iv), 4)
    assert got.shape == (2, 8, 6, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_epipolar_depth_interval(scale):
    s = scenes(2, 48, 64)
    rng = np.random.default_rng(1)
    h, w = int(48 * scale), int(64 * scale)
    d = (s["depths"][:, 0, ::int(1 / scale), ::int(1 / scale)]
         * rng.uniform(0.95, 1.05, (2, h, w))).astype(np.float32)
    k = np.asarray(jax_scale_k(jnp.asarray(s["intrinsics"]), scale))
    e = s["extrinsics"]
    want = jax.jit(jax.vmap(jdepth.epipolar_depth_interval))(
        d, k[:, 0], e[:, 0], k[:, 1], e[:, 1])
    got = depth.epipolar_depth_interval(_t(d), _t(k[:, 0]), _t(e[:, 0]),
                                        _t(k[:, 1]), _t(e[:, 1]))
    assert got.shape == (2,) and np.all(np.asarray(want) > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 24, 32, 3), (1, 2, 15, 22, 3)])
def test_downsample_bilinear_matches_jax(shape):
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    out = shape[:2] + (shape[2] // 2, shape[3] // 2, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "bilinear"))
    got = downsample_bilinear(_t(x), out[2], out[3]).numpy()
    assert got.shape == out
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_in,n_out", [(12, 24), (7, 14), (37, 74),
                                        (24, 12)])
def test_cubic_weights_match_jax(n_in, n_out):
    want = jax.jit(compute_weight_mat, static_argnums=range(6))(
        n_in, n_out, n_out / n_in, 0.0, _fill_keys_cubic_kernel, True)
    got = cubic_weight_matrix(n_in, n_out)
    assert got.shape == (n_in, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_resize_cubic_matches_jax():
    x = np.random.default_rng(3).uniform(400, 900, (2, 12, 16)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 24, 32), "cubic"))
    got = resize_cubic(_t(x), 24, 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    # torch's bicubic (a = -0.75, taps clamped) is another function, even
    # away from the border.
    torch_bicubic = F.interpolate(_t(x)[:, None], size=(24, 32),
                                  mode="bicubic", align_corners=False)[:, 0]
    assert np.abs(torch_bicubic.numpy() - want)[:, 4:-4, 4:-4].max() > 1.0


def test_stride1_conv_transpose_block():
    x = np.random.default_rng(4).standard_normal((2, 4, 6, 8, 16)).astype(
        np.float32)
    port = ConvTransposeBlock(16, 8, stride=1)
    got, want, variables = run_both(
        jblocks.ConvTransposeBlock(8, (3, 3, 3), strides=1), port, x)
    assert got.shape == (2, 4, 6, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # Stored as every transposed kernel is, (I, O, 3, 3, 3) flipped in
    # space; in eval mode the block undoes the flip for the fused conv3d
    # kernel.
    flax_kernel = np.asarray(variables["params"]["ConvTranspose_0"]["kernel"])
    np.testing.assert_array_equal(
        port.ConvTranspose_0.kernel.detach().numpy(),
        flax_kernel[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))


def test_attention_conv():
    x = np.random.default_rng(5).standard_normal((2, 9, 11, 16)).astype(
        np.float32)
    got, want, _ = run_both(JaxAttentionConv(16), AttentionConv(16, 16), x)
    assert got.shape == (2, 9, 11, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("attention", [False, True])
def test_pyramid_feature_net(attention):
    x = np.random.default_rng(6).uniform(0, 1, (2, 16, 20, 3)).astype(
        np.float32)
    got, want, _ = run_both(JaxFeatureNet(16, attention),
                            PyramidFeatureNet(16, attention), x)
    assert got.shape == (2, 16, 20, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("in_channels", [16, 4])
def test_pyramid_cost_reg_net(in_channels):
    x = np.random.default_rng(7).standard_normal(
        (1, 8, 8, 12, in_channels)).astype(np.float32)
    got, want, _ = run_both(JaxPyramidCostRegNet(16),
                            PyramidCostRegNet(in_channels, 16), x)
    assert got.shape == (1, 8, 8, 12)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_odd_level_is_the_reference_limit():
    """mvs_tpu's PyramidCostRegNet fails at an odd size (its stride-2
    transposed block gives 6 rows where the skip has 5); the port raises a
    ValueError naming the limit before any work."""
    x = jnp.zeros((1, 4, 5, 6, 2))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(JaxPyramidCostRegNet(16).init, jax.random.key(0), x)
    with pytest.raises(ValueError, match="even D, H and W"):
        PyramidCostRegNet(2, 16).eval()(torch.zeros(1, 4, 5, 6, 2))


def test_model_at_odd_coarsest_level_raises():
    """3 levels at 60x80: the coarsest level has 15 rows. mvs_tpu fails in
    its regularizer; the port names the limit (H, W divisible by 2^3)."""
    s = scenes(1, 60, 80)
    args = (jnp.asarray(s["images"]), jnp.asarray(s["intrinsics"]),
            jnp.asarray(s["extrinsics"]), jnp.asarray([8.0]),
            jnp.asarray([12.0]))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: JaxCVPMVSNet(num_levels=3).init(
            jax.random.key(0), *args))
    model = CVPMVSNet(num_levels=3).eval()
    with pytest.raises(ValueError, match=r"divisible by 2\^3 = 8"):
        model(*(_t(a) for a in args))


@pytest.fixture(scope="module")
def cvp_outputs():
    """CVP-MVSNet, 3 levels at 64x80, 3 views, batch 2, epipolar interval
    on, f32: (port outputs, JAX outputs)."""
    s = scenes(2, 64, 80)
    args = (s["images"], s["intrinsics"], s["extrinsics"],
            np.array([8.0, 8.5], np.float32), np.array([12.0, 12.5],
                                                       np.float32))
    jmodel = JaxCVPMVSNet(num_levels=3, use_epipolar_interval=True)
    variables = init_variables(jmodel, *args)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *args)
    model = CVPMVSNet(num_levels=3, use_epipolar_interval=True)
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = model.eval()(*(_t(a) for a in args))
    return got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_cvp_depth_matches_jax(cvp_outputs, level):
    got, want = cvp_outputs
    g, w = got["depth_levels"][level].numpy(), want["depth_levels"][level]
    assert g.shape == w.shape == (2, 64 // 2 ** level, 80 // 2 ** level)
    np.testing.assert_allclose(g, w, rtol=1e-4)


def test_cvp_confidence_matches_jax(cvp_outputs):
    got, want = cvp_outputs
    np.testing.assert_array_equal(got["depth"].numpy(),
                                  got["depth_levels"][0].numpy())
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               want["photometric_confidence"], atol=1e-4)


def test_cvp_eval_config_loads_and_builds():
    cfg = load_config(str(CONFIG), ["data.align=32"])
    m, d = cfg.model, cfg.data
    assert (m.name, m.num_levels, m.coarse_depths, m.num_offsets,
            m.use_epipolar_interval, m.compute_dtype) == (
        "cvp_mvsnet", 5, 48, 4, True, "bfloat16")
    assert (d.num_views, d.max_h, d.max_w, d.align, d.batch_size) == (
        5, 1200, 1600, 32, 1)
    assert cfg.fusion.conf_thresh == 0.9 and cfg.fusion.num_consistent == 3
    # A DTU image of 1600x1200 at align 32 is cut to 1600x1184.
    img, _ = _scale_to_fit(np.zeros((1200, 1600, 3), np.float32),
                           np.eye(3, dtype=np.float32), d.max_h, d.max_w,
                           d.align)
    assert img.shape == (1184, 1600, 3)
    for name, attention, volume_channels in (("cvp_mvsnet", False, 16),
                                             ("aacvp_mvsnet", True, 4)):
        cfg.model.name = name
        model = build_model(cfg)
        assert isinstance(model, CVPMVSNet) and model.family == "pyramid"
        assert model.compute_dtype == torch.bfloat16
        assert model.PyramidFeatureNet_0.attention == attention
        reg = model.PyramidCostRegNet_0
        assert reg.FusedConvBlock3D_0.kernel.shape == (16, volume_channels,
                                                       3, 3, 3)
        assert reg.ConvTransposeBlock_0.ConvTranspose_0.kernel.shape == (
            64, 32, 3, 3, 3)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_apply_fn(model)


def test_cli_infer_cvp_eval_config(tmp_path):
    """`infer --config configs/cvp_eval_dtu.yaml` (5 levels, 48 coarse
    hypotheses, epipolar interval, bf16) on the CPU at 64x96 on the port's
    synthetic fixture, from JAX variables exported to .npz and from a .pt:
    both write the maps of the port's model on the same samples."""
    root = generate(tmp_path / "dtu", num_scans=1, num_views=3, height=64,
                    width=96, num_depth=16, tilt=(0.05, 0.02),
                    train_layout=False)
    overrides = [f"data.eval_root={root}",
                 f"data.eval_list={root / 'lists' / 'test.txt'}",
                 "data.num_views=3", "data.max_h=64", "data.max_w=96",
                 "data.align=32"]
    cfg = load_config(str(CONFIG), overrides)
    d = cfg.data
    ds = DTUEvalDataset(root, ["scan1"], num_views=d.num_views,
                        num_depth=d.num_depth,
                        interval_scale=d.interval_scale, max_h=d.max_h,
                        max_w=d.max_w, align=d.align)
    variables = init_variables(
        JaxCVPMVSNet(num_levels=5, use_epipolar_interval=True),
        *(jnp.asarray(a) for a in stack_model_inputs([ds[0]], "cpu",
                                                     "pyramid")), seed=8)
    npz = tmp_path / "cvp.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     flatten_dict(variables, sep="/").items()})
    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(variables))
    pt = tmp_path / "cvp.pt"
    torch.save(model.state_dict(), pt)
    want_d, want_c = make_apply_fn(model, "cpu")(
        *stack_model_inputs([ds[0]], "cpu", "pyramid"))

    maps = {}
    for ckpt in (npz, pt):
        out = tmp_path / f"out_{ckpt.suffix[1:]}"
        result = infer.main(["--config", str(CONFIG), "--ckpt", str(ckpt),
                             "--out", str(out), "--device", "cpu",
                             *overrides])
        assert result["maps"] == len(ds) == 3
        for i in range(len(ds)):
            got_d, _ = read_pfm(out / "scan1" / "depth_est" / f"{i:08d}.pfm")
            got_c, _ = read_pfm(out / "scan1" / "confidence" / f"{i:08d}.pfm")
            assert got_d.shape == (64, 96) and np.isfinite(got_d).all()
            cam = read_cam_file(out / "scan1" / "cams" / f"{i:08d}_cam.txt")
            np.testing.assert_allclose(cam.intrinsics, ds[i]["intrinsics"][0],
                                       rtol=1e-6)
            maps.setdefault(i, []).append((got_d, got_c))
    np.testing.assert_array_equal(maps[0][0][0], want_d[0].float().numpy())
    np.testing.assert_array_equal(maps[0][0][1], want_c[0].float().numpy())
    for (d_npz, c_npz), (d_pt, c_pt) in maps.values():
        np.testing.assert_array_equal(d_npz, d_pt)
        np.testing.assert_array_equal(c_npz, c_pt)

"""The port's MVSNet inference and the modules it adds, against mvs_tpu's on
the CPU (JAX_PLATFORMS=cpu, exact gather sampler).

One JAX reference is built per module: MVSNet with RefineNet at 64x64, 3
views, batch 2, a 16-hypothesis ladder, non-trivial BatchNorm, initialised
by jax.jit(model.init); the port gets its weights through
convert.flax_to_state_dict. Bounds, with their reasons:
  * f32, refine off and on: depth and refined depth rtol 1e-4, confidence
    and prob_volume atol 1e-4, as tests/test_torch_cas_mvsnet.py (f32
    rounding through the net);
  * bf16 against the JAX f32 model: each output's largest and mean error
    within twice what mvs_tpu's own bf16 model is off that f32 output (bf16
    rounds every layer's output on both sides; the port sums the variance
    in f32 where mvs_tpu sums it in bf16, so the port lands nearer f32:
    0.76-0.99x on these inputs);
  * MVSNetFeatureNet alone (odd and even sizes), and the antialiased x1/4
    image resize of RefineNet: 1e-5 and 1e-6 of the largest magnitude.
The bf16 model runs RefineNet in f32 with a residual that is never
negative, as the JAX module does; a size that the U-Net cannot halve and
double back raises before any work; stack_model_inputs matches
mvs_tpu.cli.infer's for the "single" family; `cli infer` writes the 1/4-
resolution maps with intrinsics rescaled to them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.cli.infer import stack_model_inputs as jax_stack_model_inputs
from mvs_tpu.models.mvsnet import MVSNet as JaxMVSNet
from mvs_tpu.nn.feature_nets import MVSNetFeatureNet as JaxMVSNetFeatureNet
from mvs_tpu.utils.config import load_config as jax_load_config
from mvs_tpu_torch.cli import infer
from mvs_tpu_torch.cli.infer import (make_apply_fn, run_batched_inference,
                                     stack_model_inputs, write_depth_outputs)
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.geometry.resize import downsample_bilinear
from mvs_tpu_torch.io import read_cam_file, read_pfm
from mvs_tpu_torch.io.dtu import DTUEvalDataset
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.nn.feature_nets import MVSNetFeatureNet
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_blocks import perturb_batch_norm
from test_torch_train_blocks import random_variables

SIZE, VIEWS, DEPTHS = 64, 3, 16
KEYS = ("depth", "photometric_confidence", "prob_volume", "refined_depth")


def _sample(seed, ref_view=0, size=SIZE):
    scene = make_plane_scene(num_views=VIEWS, height=size, width=size,
                             z0=10.0, seed=seed, tilt=(0.05, 0.02))
    return dict(imgs=scene.images, intrinsics=scene.intrinsics,
                extrinsics=scene.extrinsics,
                depth_values=np.linspace(8.0, 12.0, DEPTHS, dtype=np.float32),
                scan="scan1", ref_view=ref_view, depth_min=8.0,
                depth_interval=4.0 / (DEPTHS - 1), depth_max=12.0)


def _without_refine(state: dict) -> dict:
    return {k: v for k, v in state.items() if not k.startswith("RefineNet")}


@pytest.fixture(scope="module")
def reference():
    """The JAX model's f32 and bf16 outputs and the port's converted
    weights, on one batch of two samples."""
    samples = [_sample(0), _sample(1)]
    inputs = stack_model_inputs(samples, "cpu", "single")
    jinputs = [jnp.asarray(t.numpy()) for t in inputs]
    jmodel = JaxMVSNet(refine=True, sampler="gather")
    variables = perturb_batch_norm(
        jax.jit(jmodel.init, static_argnames=("train",))(
            jax.random.key(0), *jinputs, train=False), 1)
    want = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        model = JaxMVSNet(refine=True, sampler="gather", compute_dtype=dtype)
        out = jax.jit(lambda v, *a, m=model: m.apply(v, *a, train=False))(
            variables, *jinputs)
        want[dtype] = {k: np.asarray(out[k], np.float32) for k in KEYS}
        if dtype == jnp.bfloat16:
            refined_dtype = out["refined_depth"].dtype
    return dict(samples=samples, inputs=inputs, want=want[jnp.float32],
                want_bf16=want[jnp.bfloat16], bf16_refined_dtype=refined_dtype,
                state=flax_to_state_dict(variables))


def _port(reference, refine=True, dtype=torch.float32):
    model = MVSNet(refine=refine, compute_dtype=dtype)
    state = reference["state"]
    model.load_state_dict(state if refine else _without_refine(state))
    model.eval()
    with torch.no_grad():
        return model(*reference["inputs"])


@pytest.mark.parametrize("refine", [False, True])
def test_forward_matches_jax(reference, refine):
    got, want = _port(reference, refine), reference["want"]
    assert set(got) == set(KEYS[:3 + refine])
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == torch.float32, k
        if k.endswith("depth"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                       err_msg=k)
    assert got["depth"].shape == (2, SIZE // 4, SIZE // 4)
    assert got["prob_volume"].shape == (2, DEPTHS, SIZE // 4, SIZE // 4)


def test_bf16_matches_jax_within_its_own_bf16_error(reference):
    got = _port(reference, dtype=torch.bfloat16)
    want, jax_bf16 = reference["want"], reference["want_bf16"]
    for k in KEYS:
        err = np.abs(got[k].float().numpy() - want[k])
        own = np.abs(jax_bf16[k] - want[k])
        assert err.max() <= 2 * own.max(), (k, err.max(), own.max())
        assert err.mean() <= 2 * own.mean(), (k, err.mean(), own.mean())
        assert 0 < own.max() < 1e-2, k  # bf16 does round, by little


def test_refine_net_computes_in_f32_with_a_nonnegative_residual(reference):
    """In the bf16 model RefineNet's convs see f32 (in JAX the concatenation
    with the f32 depth promotes them), and its last ConvBlock keeps its
    BatchNorm and ReLU, so refined_depth >= depth everywhere."""
    model = MVSNet(refine=True, compute_dtype=torch.bfloat16)
    model.load_state_dict(reference["state"])
    model.eval()
    seen = []
    hook = model.RefineNet_0.ConvBlock_0.register_forward_hook(
        lambda m, a, out: seen.append((a[0].dtype, out.dtype)))
    with torch.no_grad():
        out = model(*reference["inputs"])
    hook.remove()
    assert seen == [(torch.float32, torch.float32)]
    assert out["refined_depth"].dtype == torch.float32
    residual = out["refined_depth"] - out["depth"]
    assert residual.min() >= 0 and residual.max() > 0
    assert (residual == 0).any()  # the ReLU clips somewhere
    assert reference["bf16_refined_dtype"] == jnp.float32


@pytest.mark.parametrize("size", [(33, 47), (32, 48)])
def test_feature_net_matches_jax(size):
    """Odd and even sizes: the two 5x5 stride-2 convs take flax SAME
    padding ((1, 2) at even sizes, (2, 2) at odd ones)."""
    x = np.random.default_rng(size[0]).uniform(0, 1, (2, *size, 3)).astype(
        np.float32)
    jnet = JaxMVSNetFeatureNet()
    variables = random_variables(jnet, jnp.asarray(x), seed=size[1])
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = MVSNetFeatureNet()
    net.load_state_dict(flax_to_state_dict(variables))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-size[0] // 4), -(-size[1] // 4),
                                       32)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(64, 64), (64, 80), (63, 81)])
def test_refine_image_resize_matches_jax(shape):
    """RefineNet brings the image to depth resolution (x1/4) with
    jax.image.resize(..., "bilinear"), which antialiases."""
    img = np.random.default_rng(1).uniform(0, 1, (2, *shape, 3)).astype(
        np.float32)
    h, w = shape[0] // 4, shape[1] // 4
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, h, w, 3),
                                       method="bilinear"))
    got = downsample_bilinear(torch.from_numpy(img), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("size,depths", [((64, 80), 16), ((80, 64), 16),
                                         ((64, 64), 12)])
def test_sizes_the_unet_cannot_take_raise(size, depths):
    model = MVSNet()
    model.eval()
    imgs = torch.zeros((1, VIEWS, *size, 3))
    with pytest.raises(ValueError, match="divisible by 32 and D by 8"):
        model(imgs, torch.eye(4).repeat(1, VIEWS, 1, 1),
              torch.linspace(8, 12, depths)[None])


def test_stack_model_inputs_matches_jax():
    samples = [_sample(0), _sample(3)]
    got = stack_model_inputs(samples, "cpu", "single")
    want = jax_stack_model_inputs(
        jax_load_config(None, ["model.name=mvsnet"]), samples)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_registry_builds_mvsnet():
    model = build_model(load_config(None, [
        "model.name=mvsnet", "model.refine=true",
        "model.compute_dtype=bfloat16", "model.base_channels=4"]))
    assert isinstance(model, MVSNet) and model.family == "single"
    assert model.compute_dtype == torch.bfloat16
    assert model.RefineNet_0 is not None
    assert model.MVSNetFeatureNet_0.FoldedConv_0.kernel.shape == (16, 16, 3,
                                                                   3)
    assert build_model(load_config(None, ["model.name=mvsnet"])
                       ).RefineNet_0 is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_apply_fn(model)


def test_depth_outputs_carry_quarter_resolution_intrinsics(reference,
                                                           tmp_path):
    """The maps are at 1/4 of the images; write_depth_outputs rescales the
    reference intrinsics to them, so fusion pairs each map with its K."""
    model = MVSNet(refine=True)
    model.load_state_dict(reference["state"])
    results = list(run_batched_inference(model, reference["samples"][:1],
                                         batch_size=1, device="cpu"))
    sample, depth, conf = results[0]
    assert depth.shape == (SIZE // 4, SIZE // 4)
    np.testing.assert_allclose(depth, reference["want"]["depth"][0],
                               rtol=1e-4)
    write_depth_outputs(tmp_path, sample, depth, conf, num_depth=DEPTHS)
    cam = read_cam_file(tmp_path / "scan1" / "cams" / "00000000_cam.txt")
    k = np.array(sample["intrinsics"][0], np.float64)
    k[:2] *= 0.25
    np.testing.assert_allclose(cam.intrinsics, k, rtol=1e-6)


def test_cli_infer_mvsnet(reference, tmp_path):
    """`infer model.name=mvsnet` on the CPU over the port's synthetic eval
    layout (64x64, 3 views): the maps of the port's model on the same
    samples, at 1/4 resolution, with their cams."""
    root = generate(tmp_path / "dtu", num_scans=1, num_views=VIEWS,
                    height=SIZE, width=SIZE, num_depth=DEPTHS,
                    tilt=(0.05, 0.02), train_layout=False)
    overrides = ["model.name=mvsnet", "model.refine=true",
                 f"data.eval_root={root}",
                 f"data.eval_list={root / 'lists' / 'test.txt'}",
                 f"data.num_views={VIEWS}", f"data.num_depth={DEPTHS}",
                 f"data.max_h={SIZE}", f"data.max_w={SIZE}",
                 "data.batch_size=2"]
    cfg = load_config(None, overrides)
    ds = DTUEvalDataset(root, ["scan1"], num_views=VIEWS, num_depth=DEPTHS,
                        interval_scale=cfg.data.interval_scale, max_h=SIZE,
                        max_w=SIZE, align=cfg.data.align)
    model = build_model(cfg)
    model.load_state_dict(reference["state"])
    ckpt = tmp_path / "mvsnet.pt"
    torch.save(model.state_dict(), ckpt)
    want_d, want_c = make_apply_fn(model, "cpu")(
        *stack_model_inputs([ds[0]], "cpu", "single"))
    out = tmp_path / "out"
    result = infer.main(["--ckpt", str(ckpt), "--out", str(out), "--device",
                         "cpu", *overrides])
    assert result["maps"] == len(ds) == VIEWS
    for i in range(VIEWS):
        depth, _ = read_pfm(out / "scan1" / "depth_est" / f"{i:08d}.pfm")
        assert depth.shape == (SIZE // 4, SIZE // 4)
        assert np.isfinite(depth).all()
        cam = read_cam_file(out / "scan1" / "cams" / f"{i:08d}_cam.txt")
        k = np.array(ds[i]["intrinsics"][0], np.float64)
        k[:2] *= 0.25
        np.testing.assert_allclose(cam.intrinsics, k, rtol=1e-6)
    depth, _ = read_pfm(out / "scan1" / "depth_est" / "00000000.pfm")
    conf, _ = read_pfm(out / "scan1" / "confidence" / "00000000.pfm")
    np.testing.assert_allclose(depth, want_d[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(conf, want_c[0].numpy(), atol=1e-6)

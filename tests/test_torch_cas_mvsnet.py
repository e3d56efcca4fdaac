"""The port's CasMVSNet against mvs_tpu's on the CPU, and its batched
inference driver.

One JAX reference (32x32, 3 views, ndepths 8/8/8, f32, non-trivial
BatchNorm) is built per module; the port gets its weights through
convert.flax_to_state_dict. Depth is compared at rtol 1e-4 (relative to
depths of ~10: f32 rounding through three cascade stages), confidence at
atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.geometry import compose_projection, scale_intrinsics
from mvs_tpu.models.cas_mvsnet import CasMVSNet as JaxCasMVSNet
from mvs_tpu_torch.cli.infer import (make_apply_fn, run_batched_inference,
                                     stack_model_inputs, write_depth_outputs)
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io import read_cam_file, read_pfm
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.utils.platform import resolve_device
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_blocks import perturb_batch_norm

NDEPTHS = (8, 8, 8)


def _sample(seed, scan="scan1", ref_view=0, size=(32, 32)):
    scene = make_plane_scene(num_views=3, height=size[0], width=size[1],
                             z0=10.0, seed=seed, tilt=(0.05, 0.02))
    return dict(imgs=scene.images, intrinsics=scene.intrinsics,
                extrinsics=scene.extrinsics,
                depth_values=np.linspace(8.0, 12.0, 16, dtype=np.float32),
                scan=scan, ref_view=ref_view, depth_min=8.0,
                depth_interval=0.25, depth_max=12.0)


@pytest.fixture(scope="module")
def models_and_outputs():
    samples = [_sample(0), _sample(1)]
    imgs = jnp.asarray(np.stack([s["imgs"] for s in samples]))
    intr = jnp.asarray(np.stack([s["intrinsics"] for s in samples]))
    extr = jnp.asarray(np.stack([s["extrinsics"] for s in samples]))
    proj = {f"stage{i + 1}": compose_projection(scale_intrinsics(intr, f),
                                                extr)
            for i, f in enumerate((0.25, 0.5, 1.0))}
    dv = jnp.asarray(np.stack([s["depth_values"] for s in samples]))
    jmodel = JaxCasMVSNet(ndepths=NDEPTHS)
    variables = perturb_batch_norm(
        jax.jit(jmodel.init, static_argnames=("train",))(
            jax.random.key(0), imgs, proj, dv, train=False), 1)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, imgs, proj, dv)
    model = CasMVSNet(ndepths=NDEPTHS)
    model.load_state_dict(flax_to_state_dict(variables))
    model.eval()
    with torch.no_grad():
        got = model(*stack_model_inputs(samples, "cpu"))
    return model, samples, got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("key", ["depth", "stage1", "stage2"])
def test_depth_matches_jax(models_and_outputs, key):
    _, _, got, want = models_and_outputs
    g = got[key] if key == "depth" else got[key]["depth"]
    w = want[key] if key == "depth" else want[key]["depth"]
    assert g.shape == w.shape
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-4)


@pytest.mark.parametrize("key", ["photometric_confidence", "prob_volume"])
def test_confidence_matches_jax(models_and_outputs, key):
    _, _, got, want = models_and_outputs
    g = got[key] if key == "photometric_confidence" else \
        got["stage3"]["prob_volume"]
    w = want[key] if key == "photometric_confidence" else \
        want["stage3"]["prob_volume"]
    np.testing.assert_allclose(g.numpy(), w, atol=1e-4)


def test_batched_inference_pads_tail_and_writes_outputs(models_and_outputs,
                                                        tmp_path):
    model, samples, got, _ = models_and_outputs
    samples = samples + [_sample(2, ref_view=2)]
    for i, s in enumerate(samples):
        s["ref_view"] = i
    results = list(run_batched_inference(model, samples, batch_size=2,
                                         device="cpu"))
    # 3 samples at batch 2: one full batch and a tail padded to 2.
    assert [r[0]["ref_view"] for r in results] == [0, 1, 2]
    np.testing.assert_allclose(results[0][1], got["depth"][0].numpy(),
                               rtol=1e-6)
    single = list(run_batched_inference(model, samples[2:], batch_size=1,
                                        device="cpu"))
    np.testing.assert_allclose(results[2][1], single[0][1], rtol=1e-5)
    np.testing.assert_allclose(results[2][2], single[0][2], atol=1e-5)

    sample, depth, conf = results[2]
    write_depth_outputs(tmp_path, sample, depth, conf, num_depth=16)
    scan = tmp_path / "scan1"
    back, _ = read_pfm(scan / "depth_est" / "00000002.pfm")
    np.testing.assert_array_equal(back, depth.astype(np.float32))
    back, _ = read_pfm(scan / "confidence" / "00000002.pfm")
    np.testing.assert_array_equal(back, conf.astype(np.float32))
    cam = read_cam_file(scan / "cams" / "00000002_cam.txt")
    np.testing.assert_allclose(cam.intrinsics, sample["intrinsics"][0],
                               rtol=1e-6)  # depth map at image resolution
    assert cam.num_depth == 16 and cam.depth_max == 12.0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_apply_fn(CasMVSNet(ndepths=(8,)))

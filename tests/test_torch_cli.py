"""The port's CLIs end to end on the CPU against mvs_tpu's, on a synthetic
DTU eval split written by mvs_tpu's generator (JPEG images, 2 scans x 5
views at 32x64).

CasMVSNet variables in the Flax layout (8/8/8 hypotheses; the tree of
jax.eval_shape(model.init), which costs no compile, filled from a seed:
kernels N(0, 1/fan_in), non-trivial BatchNorm) are exported to .npz, the
form README.md gives for a JAX checkpoint. `infer` must write the depth
maps mvs_tpu's run_batched_inference computes over the same dataset: depth
to rtol 1e-4, confidence to atol 1e-4 (as tests/test_torch_cas_mvsnet.py). `fuse` runs
on those maps beside mvs_tpu.cli.fuse.fuse_scan_dir, and `evaluate` beside
mvs_tpu's evaluation of the JAX cloud: the fusion masks and points agree
within the tolerance of tests/test_torch_fusion.py (1e-3 of the pixels may
flip, points on the common mask to rtol 1e-5), so acc / comp agree to 1e-3
relative.
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import mvs_tpu.native
from mvs_tpu.cli.evaluate import main as jax_evaluate_main
from mvs_tpu.cli.fuse import fuse_scan_dir as jax_fuse_scan_dir
from mvs_tpu.cli.fuse import load_scan_arrays as jax_load_scan_arrays
from mvs_tpu.cli.infer import run_batched_inference as jax_run_batched
from mvs_tpu.cli.infer import stack_model_inputs as jax_stack_inputs
from mvs_tpu.fusion import FusionConfig as JaxFusionConfig
from mvs_tpu.fusion import fuse_scene as jax_fuse_scene
from mvs_tpu.io.dtu import DTUEvalDataset as JaxDTUEvalDataset
from mvs_tpu.models.cas_mvsnet import CasMVSNet as JaxCasMVSNet
from mvs_tpu.utils.config import load_config as jax_load_config
from mvs_tpu.utils.make_synthetic_dtu import generate as jax_generate
from mvs_tpu_torch.cli import evaluate, fuse, infer
from mvs_tpu_torch.cli.__main__ import main as cli_main
from mvs_tpu_torch.convert import (flax_to_state_dict, load_flax_npz,
                                   load_weights)
from mvs_tpu_torch.fusion import FusionConfig, compact_points, fuse_scene
from mvs_tpu_torch.io import read_cam_file, read_pfm, read_ply, read_png
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.utils.config import load_config
from test_torch_blocks import perturb_batch_norm

MASK_SHARE = 1e-3
FUSION = ["fusion.conf_thresh=0.2", "fusion.num_consistent=2",
          "fusion.pixel_thresh=2.0", "fusion.depth_thresh=0.05"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The split, the exported weights, mvs_tpu's maps and the port's CLI
    outputs (infer + fuse + evaluate)."""
    tmp = tmp_path_factory.mktemp("cli")
    root = jax_generate(tmp / "dtu", num_scans=2, num_views=5, height=32,
                        width=64, num_depth=16, tilt=(0.05, 0.02))
    overrides = ["model.ndepths=8,8,8", f"data.eval_root={root}",
                 f"data.eval_list={root / 'lists' / 'test.txt'}",
                 "data.num_views=3", "data.num_depth=16",
                 "data.interval_scale=1.0", "data.max_h=32", "data.max_w=64",
                 "data.batch_size=3"]  # 10 maps: 3 full batches + a tail
    jcfg = jax_load_config(None, overrides)
    ds = JaxDTUEvalDataset(root, ["scan1", "scan2"], num_views=3,
                           num_depth=16, interval_scale=1.0, max_h=32,
                           max_w=64)
    samples = [ds[i] for i in range(len(ds))]
    model = JaxCasMVSNet(ndepths=(8, 8, 8))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0),
                           *jax_stack_inputs(jcfg, samples[:3]), train=False))
    rng = np.random.default_rng(0)
    variables = perturb_batch_norm(jax.tree.map(
        lambda x: (rng.normal(0.0, 1.0, x.shape)
                   / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        if len(x.shape) > 1 else np.zeros(x.shape, np.float32), shapes), 1)
    npz = tmp / "cas.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     flatten_dict(variables, sep="/").items()})
    want = {(s["scan"], s["ref_view"]): (d, c) for s, d, c in
            jax_run_batched(jcfg, model, variables, samples, 3)}

    out = tmp / "out"
    infer_result = infer.main(["--ckpt", str(npz), "--out", str(out),
                               "--device", "cpu", *overrides])
    plys = fuse.main(["--out", str(out), "--device", "cpu",
                      f"data.eval_root={root}", *FUSION])
    report = evaluate.main(["--out", str(out), "--gt", str(root),
                            "--report", str(tmp / "report.json")])
    return dict(root=root, out=out, npz=npz, variables=variables,
                samples=samples, want=want, infer=infer_result, plys=plys,
                report=report, report_path=tmp / "report.json")


def test_infer_writes_jax_depth_maps(run):
    assert run["infer"]["maps"] == 10 and run["infer"]["seconds"] > 0
    for (scan, ref), (depth, conf) in run["want"].items():
        got_d, _ = read_pfm(run["out"] / scan / "depth_est" / f"{ref:08d}.pfm")
        got_c, _ = read_pfm(run["out"] / scan / "confidence"
                            / f"{ref:08d}.pfm")
        assert got_d.shape == depth.shape == (32, 64)
        np.testing.assert_allclose(got_d, depth, rtol=1e-4)
        np.testing.assert_allclose(got_c, conf, atol=1e-4)


def test_infer_writes_cams_and_png_images(run):
    for s in run["samples"]:
        scan_dir = run["out"] / s["scan"]
        cam = read_cam_file(scan_dir / "cams" / f"{s['ref_view']:08d}_cam.txt")
        np.testing.assert_allclose(cam.intrinsics, s["intrinsics"][0],
                                   rtol=1e-6)
        np.testing.assert_array_equal(cam.extrinsics, s["extrinsics"][0])
        assert cam.num_depth == 16
        assert cam.depth_min == pytest.approx(float(s["depth_min"]))
        img = read_png(scan_dir / "images" / f"{s['ref_view']:08d}.png")
        np.testing.assert_array_equal(
            img, (np.clip(s["imgs"][0], 0, 1) * 255).astype(np.uint8))


def test_fuse_matches_jax(run):
    """Each side loads the written maps with its own load_scan_arrays and
    fuses them; masks may flip on MASK_SHARE of the pixels, points on the
    common mask agree to rtol 1e-5, and each PLY is its own side's mask
    compacted."""
    assert [p.parent.name for p in run["plys"]] == ["scan1", "scan2"]
    jcfg = JaxFusionConfig(conf_thresh=0.2, num_consistent=2,
                           pixel_thresh=2.0, depth_thresh=0.05)
    for scan_name in ("scan1", "scan2"):
        scan_dir = run["out"] / scan_name
        pair = run["root"] / scan_name / "pair.txt"
        scan = fuse.load_scan_arrays(scan_dir, pair)
        jscan = jax_load_scan_arrays(scan_dir, pair)
        assert scan["pairs"] == jscan["pairs"]
        for key in ("depths", "confs", "images", "intr", "extr"):
            np.testing.assert_array_equal(scan[key], jscan[key])
        mask, world = fuse_scene(scan["depths"], scan["confs"], scan["intr"],
                                 scan["extr"], scan["pairs"],
                                 FusionConfig(0.2, 2, 2.0, 0.05),
                                 device="cpu")
        jmask, jworld = jax_fuse_scene(jscan["depths"], jscan["confs"],
                                       jscan["intr"], jscan["extr"],
                                       jscan["pairs"], jcfg)
        assert mask.sum() > 1000
        assert (mask != jmask).mean() <= MASK_SHARE, (mask != jmask).sum()
        both = mask & jmask
        np.testing.assert_allclose(world[both], jworld[both], rtol=1e-5,
                                   atol=1e-5)

        jax_fuse_scan_dir(scan_dir, pair, jcfg, scan_dir / "jax_fused.ply")
        for ply, m, w in (("fused.ply", mask, world),
                          ("jax_fused.ply", jmask, jworld)):
            xyz, rgb = compact_points(m, w, scan["images"], scan["pairs"])
            cloud = read_ply(scan_dir / ply)
            np.testing.assert_allclose(cloud["xyz"], xyz, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_array_equal(cloud["rgb"], rgb)


def test_evaluate_matches_jax(run, monkeypatch):
    # mvs_tpu's protocol on scipy, as the port's (tests/test_torch_dtu_eval).
    monkeypatch.setattr(mvs_tpu.native, "available", lambda: False)
    test_fuse_matches_jax(run)
    want = jax_evaluate_main(["--out", str(run["out"]), "--gt",
                              str(run["root"]), "--ply-name",
                              "jax_fused.ply", "--report",
                              str(run["report_path"]) + ".jax"])
    assert want is None  # mvs_tpu's CLI reports through --report only
    with open(str(run["report_path"]) + ".jax") as f:
        want = json.load(f)
    got = run["report"]
    with open(run["report_path"]) as f:
        assert json.load(f) == got
    assert got["aggregate"]["num_scans"] == 2
    for scan, scores in want["per_scan"].items():
        for key, value in scores.items():
            assert got["per_scan"][scan][key] == pytest.approx(value,
                                                               rel=1e-3)
    for key in ("mean_acc", "mean_comp", "overall"):
        assert got["aggregate"][key] == pytest.approx(
            want["aggregate"][key], rel=1e-3)


def test_fuse_streams_scans_in_order(run, tmp_path):
    """Many scans through the streaming path equal one scan at a time."""
    jobs = [(run["out"] / s, run["root"] / s / "pair.txt")
            for s in ("scan2", "scan1", "scan2")]
    fcfg = fuse.FusionConfig(0.2, 2, 2.0, 0.05)
    scan = fuse.load_scan_arrays(*jobs[0])
    assert scan["images"].shape == (5, 32, 64, 3)
    assert scan["pairs"][0] == (0, [1, 2, 3, 4])
    paths = fuse.fuse_scans(jobs, fcfg, devices="cpu")
    assert [p.parent.name for p in paths] == ["scan2", "scan1", "scan2"]
    single = fuse.fuse_scan_dir(*jobs[1], fcfg, tmp_path / "one.ply",
                                device="cpu")
    np.testing.assert_array_equal(read_ply(single)["xyz"],
                                  read_ply(paths[1])["xyz"])


def test_load_weights_reads_npz_and_pt(run, tmp_path):
    tree = load_flax_npz(run["npz"])
    want = flax_to_state_dict(jax.tree.map(np.asarray, run["variables"]))
    got = load_weights(run["npz"])
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert set(tree) == {"params", "batch_stats"}
    model = CasMVSNet(ndepths=(8, 8, 8))
    model.load_state_dict(got)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    back = load_weights(tmp_path / "w.pt")
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v)


def test_registry_builds_cas_mvsnet_and_names_what_is_not_ported():
    cfg = load_config(None, ["model.ndepths=8,8,8",
                             "model.compute_dtype=bfloat16",
                             "model.sampler=hat"])
    model = build_model(cfg)
    assert isinstance(model, CasMVSNet)
    assert model.ndepths == (8, 8, 8) and model.compute_dtype == torch.bfloat16
    for name in ("cvp_mvsnet", "aacvp_mvsnet"):  # ported in inference
        model = build_model(load_config(None, [f"model.name={name}"]))
        assert isinstance(model, CVPMVSNet)
    model = build_model(load_config(None, ["model.name=mvsnet",
                                           "model.refine=true"]))
    assert isinstance(model, MVSNet) and model.RefineNet_0 is not None
    # Point-MVSNet builds, in float32 only (mvs_tpu's has no other dtype).
    model = build_model(load_config(None, ["model.name=point_mvsnet"]))
    assert isinstance(model, PointMVSNet) and model.family == "point"
    with pytest.raises(ValueError, match="float32 only"):
        build_model(load_config(None, ["model.name=point_mvsnet",
                                       "model.compute_dtype=bfloat16"]))
    # The variants build as mvs_tpu's registry builds them.
    model = build_model(load_config(None, ["model.share_cr=true",
                                           "model.arch_mode=unet",
                                           "model.normalization=none"]))
    assert isinstance(model, CasMVSNet) and model.share_cr
    with pytest.raises(ValueError, match="normalization"):
        build_model(load_config(None, ["model.normalization=layer"]))
    with pytest.raises(ValueError, match="unknown model"):
        build_model(load_config(None, ["model.name=nope"]))


def test_dispatcher(run, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--help"])
    assert exc.value.code == 0 and "train|infer|fuse|evaluate|profile" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        cli_main(["profile", "--help"])
    assert exc.value.code == 0 and "--train" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown command"):
        cli_main(["serve"])
    cli_main(["evaluate", "--out", str(run["out"]), "--gt", str(run["root"])])
    assert "over 2 scans" in capsys.readouterr().out


def test_apply_fn_runs_float32_without_tf32(monkeypatch):
    """The model runs with TF32 off (cuDNN convs and matmuls in float32), and
    the caller's flags come back afterwards."""
    class Probe(torch.nn.Module):
        def forward(self, imgs, proj_matrices, depth_values):
            self.seen = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
            return {"depth": depth_values, "photometric_confidence": imgs}

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    probe = Probe()
    infer.make_apply_fn(probe, "cpu")(torch.ones(1), {}, torch.ones(2))
    assert probe.seen == (False, False)
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_infer_default_device_is_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--ckpt", str(run["npz"]), "--out", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuse.main(["--out", str(run["out"])])

"""Group norm through whole models: MVSNet (with RefineNet), CVP-MVSNet,
AACVP-MVSNet and Point-MVSNet with normalization="group" against
mvs_tpu's on the CPU, eval mode, f32, weights drawn in the Flax layout
(GroupNorm scale U(0.5, 1.5), bias N(0, 0.2)) and carried over by
convert.flax_to_state_dict. Tolerances are those of each family's own
parity file where they hold: MVSNet's depths rtol 1e-4
(tests/test_torch_mvsnet.py), confidences atol 1e-4, Point-MVSNet on
mvs_tpu's kNN graphs with check_coarse / check_flow
(tests/test_torch_point_mvsnet.py). CVP-MVSNet's depths are held within
1e-4 of each level's depth range (rtol 1e-4 in tests/test_torch_cvp.py):
a group norm's f32 moments of a level's whole volume round differently in
XLA and torch, and random weights put some depths near 0, where a
relative bound means nothing. At 64x80, level 1, mvs_tpu's f32 depth lies
9.2e-5 from the port's float64 one and the port's f32 1.6e-5 (6.7e-5 of
the range apart; level 0, 5.2e-4 of a 38.6 range). The tiled sub-flow's
group statistics: tests/test_torch_group_subflow.py.
"""

import jax
import numpy as np
import pytest
import torch

from mvs_tpu.models.cvp_mvsnet import CVPMVSNet as JaxCVPMVSNet
from mvs_tpu.models.mvsnet import MVSNet as JaxMVSNet
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from test_torch_cvp import _t, init_variables, scenes
from test_torch_point_mvsnet import (DEPTH_INTERVAL, check_coarse,
                                     check_flow, flax_variables,
                                     run_point_model)
from test_torch_point_mvsnet import scene  # noqa: F401 (fixture)

GROUP = dict(normalization="group")


def _run(jmodel, port, args):
    variables = init_variables(jmodel, *args)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *args)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(*(_t(a) for a in args))
    return got, jax.tree.map(np.asarray, want)


def test_mvsnet_group_matches_jax():
    s = scenes(2, 64, 64)
    proj = s["extrinsics"].copy()
    intr = s["intrinsics"].copy()
    intr[:, :, :2] /= 4.0
    proj[..., :3, :4] = intr @ s["extrinsics"][..., :3, :4]
    ladder = np.tile(np.linspace(8.0, 12.0, 16, dtype=np.float32), (2, 1))
    got, want = _run(JaxMVSNet(refine=True, sampler="gather", **GROUP),
                     MVSNet(refine=True, **GROUP),
                     (s["images"], proj, ladder))
    for k in ("depth", "refined_depth"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               want["photometric_confidence"], atol=1e-4)


@pytest.mark.parametrize("attention", [False, True])
def test_cvp_group_matches_jax(attention):
    """CVP-MVSNet (variance) and AACVP-MVSNet (attention features, group
    correlation), 2 levels at 64x80, 3 views, batch 2."""
    s = scenes(2, 64, 80)
    args = (s["images"], s["intrinsics"], s["extrinsics"],
            np.array([8.0, 8.5], np.float32),
            np.array([12.0, 12.5], np.float32))
    kw = dict(num_levels=2, coarse_depths=16, **GROUP)
    if attention:
        kw.update(cost_mode="group_correlation", attention=True)
    got, want = _run(JaxCVPMVSNet(**kw), CVPMVSNet(**kw), args)
    for level in range(2):
        w = want["depth_levels"][level]
        np.testing.assert_allclose(got["depth_levels"][level].numpy(), w,
                                   rtol=0, atol=1e-4 * np.ptp(w))
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               want["photometric_confidence"], atol=1e-4)


def test_point_mvsnet_group_matches_jax(scene):  # noqa: F811
    """Coarse stage and two untiled flow iterations on mvs_tpu's graphs."""
    variables = flax_variables(PointMVSNet(**GROUP), seed=9)
    assert "batch_stats" not in variables
    got, want, shares = run_point_model(variables, scene, **GROUP)
    assert len(shares) == 2 and min(shares) >= 0.99, shares
    check_coarse(got, want)
    for it, inter in enumerate((0.75, 0.375)):
        check_flow(got, want, it + 1, inter * DEPTH_INTERVAL)

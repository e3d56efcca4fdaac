"""The port's tiled sub-flow (PointMVSNet.flow_sub_stride, eval only)
against mvs_tpu's on the CPU, f32: one flow iteration at half the images'
resolution (32x40 images, 2 views) split into 2 x 2 interleaved
sub-lattices of 8 x 10, each with its own kNN graph and networks. One
iteration and two views keep mvs_tpu's compile (four sub-flows) within
this file's minute; the untiled two-iteration model is
tests/test_torch_point_mvsnet.py's.

As there, the port runs on mvs_tpu's graphs after its own graphs are held
against them (run_on_jax_graphs); the port computes each sub-lattice's
variance features by slicing the full lattice's (one kernel launch per
level), mvs_tpu fetches them per sub-lattice, so the features differ by
ulps, within check_flow's limits. The sub-lattices' results are scattered
back interleaved: the test also checks that each one's probabilities land
where mvs_tpu puts them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.models.point_mvsnet import PointMVSNet as JaxPointMVSNet
from mvs_tpu.utils.synthetic import make_plane_scene
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from test_torch_point_mvsnet import (check_coarse, check_flow, flax_variables,
                                     jax_graphs, load_flax, run_on_jax_graphs)

H, W, VIEWS, NUM_DEPTH = 32, 40, 2, 8
DEPTH_START, DEPTH_INTERVAL = 8.0, 4.0 / 7
MODEL = dict(flow_scales=(0.5,), inter_scales=(0.375,), flow_sub_stride=2)


@pytest.fixture(scope="module")
def run():
    s = make_plane_scene(num_views=VIEWS, height=H, width=W, z0=10.0,
                         tilt=(0.05, 0.02))
    scene = [np.asarray(x, np.float32) for x in (
        s.images[None], s.intrinsics[None], s.extrinsics[None],
        np.array([DEPTH_START]), np.array([DEPTH_INTERVAL]))]
    variables = flax_variables(PointMVSNet(), seed=6)
    want, graphs = jax_graphs(lambda: jax.jit(
        lambda v, *a: JaxPointMVSNet(**MODEL).apply(
            v, *a, num_depth=NUM_DEPTH))(variables, *map(jnp.asarray, scene)))
    model = load_flax(PointMVSNet(num_depth=NUM_DEPTH, **MODEL),
                      variables).eval()
    with torch.no_grad():
        got, _ = run_on_jax_graphs(
            lambda: model(*[torch.tensor(x) for x in scene]), graphs)
        model.flow_sub_stride = 1
        untiled = model(*[torch.tensor(x) for x in scene])
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, graphs,
            {k: v.numpy() for k, v in untiled.items()})


def test_subflow_matches_jax(run):
    got, want, graphs, _ = run
    assert len(graphs) == 4 and all(g.shape == (1, 5 * 8 * 10, 16)
                                    for _, g in graphs)
    assert set(got) == set(want) == {
        "coarse_depth", "coarse_prob_map", "world_points", "flow1",
        "flow1_prob", "depth"}
    check_coarse(got, want)
    assert got["flow1"].shape == (1, 16, 20)
    check_flow(got, want, 1, 0.375 * DEPTH_INTERVAL)


def test_subflow_is_not_the_untiled_flow(run):
    """The sub-lattices' graphs span twice the pixel spacing: the tiled
    flow is another function than the untiled one on the same weights."""
    got, _, _, untiled = run
    np.testing.assert_array_equal(got["coarse_depth"],
                                  untiled["coarse_depth"])
    assert np.abs(got["flow1_prob"] - untiled["flow1_prob"]).max() > 1e-3

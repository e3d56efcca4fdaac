"""Point-MVSNet's tiled sub-flow under group norm, in both packages: with
flow_sub_stride the EdgeConvs and the MLP run once per sub-lattice, and a
group norm's statistics are those of its call, per sample over its points.
The test pins that axis 0 of every EdgeConv / SharedMLP input is the batch
and that a call holds one sub-lattice's points (mvs_tpu traced by
jax.eval_shape, no compile; ~26 s of tracing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvs_tpu.models.point_mvsnet import PointMVSNet as JaxPointMVSNet
from mvs_tpu.nn import point_nets as jax_nets
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.nn import point_nets
from test_torch_cvp import _t, scenes
from test_torch_point_mvsnet import NUM_DEPTH, flax_variables

GROUP = dict(normalization="group")


def test_subflow_group_statistics_are_per_sample_per_tile(monkeypatch):
    """flow_sub_stride=2 at batch 2, 32x40: each EdgeConv / SharedMLP call
    of either package takes (B, 5 * a sub-lattice's pixels, C), batch on
    axis 0 (mvs_tpu's traced by jax.eval_shape, no compile)."""
    s = scenes(2, 32, 40)
    imgs = s["images"]
    args = (imgs, s["intrinsics"], s["extrinsics"],
            np.array([8.0, 8.5], np.float32),
            np.array([0.25, 0.25], np.float32))
    jax_shapes, port_shapes = [], []
    for cls in (jax_nets.EdgeConv, jax_nets.SharedMLP):
        call = cls.__call__
        monkeypatch.setattr(cls, "__call__", lambda self, x, *a, _c=call, **k:
                            jax_shapes.append(x.shape[:-1]) or
                            _c(self, x, *a, **k))
    jmodel = JaxPointMVSNet(flow_sub_stride=2, **GROUP)
    variables = flax_variables(PointMVSNet(**GROUP), seed=9)
    jax.eval_shape(lambda: jmodel.apply(
        variables, *map(jnp.asarray, args), num_depth=NUM_DEPTH))
    model = PointMVSNet(flow_sub_stride=2, num_depth=NUM_DEPTH, **GROUP)
    model.load_state_dict(flax_to_state_dict(variables))
    for m in model.modules():
        if isinstance(m, (point_nets.EdgeConv, point_nets.SharedMLP)):
            m.register_forward_pre_hook(
                lambda mod, a: port_shapes.append(tuple(a[0].shape[:-1])))
    with torch.no_grad():
        model.eval()(*(_t(a) for a in args))
    h, w = imgs.shape[2:4]
    tiles = [(2, 5 * int(h * s) * int(w * s) // 4) for s in (0.25, 0.5)]
    # 4 EdgeConv / MLP calls per sub-lattice, 4 sub-lattices per iteration.
    assert port_shapes == [t for t in tiles for _ in range(16)]
    assert [tuple(s) for s in jax_shapes] == port_shapes

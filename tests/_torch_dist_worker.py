"""One rank of the port's CPU process-group tests (tests/test_torch_parallel*.py,
tests/test_torch_volume_sharding.py).

    python tests/_torch_dist_worker.py <inputs.pt> <out_dir>

Started by mvs_tpu_torch.parallel.launch_local with torchrun's variables;
initialises torch.distributed on the CPU (gloo), runs every case named in
inputs["cases"] and saves {case: result} to <out_dir>/rank<r>.pt. Imports
no JAX: the test process holds the results against mvs_tpu.
"""

import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet  # noqa: E402
from mvs_tpu_torch.models.mvsnet import MVSNet  # noqa: E402
from mvs_tpu_torch.nn.blocks import BatchStats  # noqa: E402
from mvs_tpu_torch.parallel import (collectives, halo,  # noqa: E402
                                    make_mesh, make_view_variance,
                                    maybe_initialize_distributed, replicate,
                                    shard_batch, sharding, use_mesh,
                                    volume_sharded_plan)
from mvs_tpu_torch.train import losses, state  # noqa: E402
from mvs_tpu_torch.train.optim import OptaxChain  # noqa: E402
from mvs_tpu_torch.train.tasks import (CascadeTask, MVSNetTask,  # noqa: E402
                                      batch_to_device)


def primitives(inp, mesh):
    """BatchNorm's moments, a masked loss and OHEM on this rank's rows:
    values under the mesh and the gradients of the rank's own rows."""
    out = {}
    y = shard_batch(inp["bn_y"], mesh).clone().requires_grad_(True)
    with use_mesh(mesh):
        mean, var = BatchStats.batch_moments(y)
    # Every rank holds the same function of the global moments: its share
    # of it is 1 / |data|.
    (grad,) = torch.autograd.grad(((mean * inp["bn_w"][0]).sum()
                                   + (var * inp["bn_w"][1]).sum())
                                  / mesh.size("data"), y)
    out["bn"] = dict(mean=mean.detach(), var=var.detach(), grad=grad)
    est, gt, mask = (shard_batch(inp[k], mesh) for k in ("est", "gt", "mask"))
    for name, fn in (("masked", losses.masked_smooth_l1),
                     ("ohem", lambda e, g, m: losses.ohem_smooth_l1(
                         e, g, m, inp["topk"]))):
        e = est.clone().requires_grad_(True)
        with use_mesh(mesh):
            share = fn(e, gt, mask)
        (grad,) = torch.autograd.grad(share, e)
        total = collectives.psum_metrics({"v": share}, mesh.group("data"))
        out[name] = dict(share=share.detach(), total=total["v"], grad=grad)
    # The wrong form: each rank's own mean, averaged over the ranks.
    own = losses.masked_smooth_l1(est, gt, mask)
    out["mean_of_means"] = collectives.psum_metrics(
        {"v": own}, mesh.group("data"))["v"] / mesh.size("data")
    return out


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x.to(dtype)


def train(inp, mesh, mode="right", steps=1, dtype="float32",
          model_name="mvsnet"):
    """`steps` train steps of the global batch (SGD) in `dtype` of MVSNet
    from inp["state"] on inp["batch"], or of CasMVSNet from
    inp["cas_state"] on inp["cas_batch"] (8 hypotheses a stage, or
    inp["cas_ndepths"]); with 'depth' or 'space' above 1 the volumes split
    by volume_sharded_plan. mode 'avg': gradients averaged over the ranks;
    'no_view_div': the loss share without the 1 / |view';
    'mean_of_means': each rank's masked means over its own counts, the
    ranks' shares averaged; 'no_copies_div': a map's share without the
    1 / (ranks holding its rows); 'data_moments': a split volume's
    BatchNorm moments over 'data' only; 'unshared': the view ranks'
    features without collectives.shared (each rank runs the feature net's
    backward on its own views' share of their cotangent). In bfloat16 the
    parameters, the batch and the sums stay f32, as cli train's are."""
    dtype = getattr(torch, dtype)
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    if model_name == "mvsnet":
        model = MVSNet(refine=inp.get("refine", False),
                       compute_dtype=dtype).to(store)
        model.load_state_dict(inp["state"])
        task, batch = MVSNetTask(model, loss_name=inp["loss"]), inp["batch"]
    else:
        model = CasMVSNet(ndepths=inp.get("cas_ndepths", (8, 8, 8)),
                          compute_dtype=dtype).to(store)
        model.load_state_dict(inp["cas_state"])
        task, batch = CascadeTask(model), inp["cas_batch"]
    if mesh.size("view") > 1:
        model.view_variance = make_view_variance(mesh)
    if mesh.size("depth") * mesh.size("space") > 1:
        model.volume_constraint = volume_sharded_plan(mesh).constrain_volume
    if mode == "no_view_div":
        right = task.loss_and_metrics
        task.loss_and_metrics = lambda b: (
            lambda lm: (lm[0] * mesh.size("view"), lm[1]))(right(b))
    saved = (state.sum_gradients, losses.global_count, losses._copies,
             sharding.VolumeShard.moments_group, collectives.shared)
    if mode == "avg":
        state.sum_gradients = lambda g, p: [
            x / mesh.world_size for x in saved[0](g, p)]
    if mode == "mean_of_means":
        losses.global_count = lambda c: c * mesh.size("data")
    if mode == "no_copies_div":
        losses._copies = lambda: 1
    if mode == "data_moments":
        sharding.VolumeShard.moments_group = property(
            lambda shard: shard.mesh.group("data"))
    if mode == "unshared":
        collectives.shared = lambda x, group: x
    try:
        opt = OptaxChain(model.parameters(), "sgd", lambda count: 1e-2)
        replicate(model, opt)
        step = state.make_train_step(task, opt, mesh=mesh)
        batch = _cast(batch_to_device(shard_batch(batch, mesh), "cpu"),
                      store)
        with float64_kept(dtype):
            for _ in range(steps):
                metrics = step(batch)
    finally:
        (state.sum_gradients, losses.global_count, losses._copies,
         sharding.VolumeShard.moments_group, collectives.shared) = saved
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def view_shared(inp, mesh):
    """The variance volume of make_view_variance on this view rank
    (float64; every rank holds the same features), and the gradients of
    its features for this rank's share of sum(volume * w), 1 / |view| of
    it, as the train step takes it: with the features' cotangent summed
    over the view group, every rank's is the whole volume's divided by
    |view|, the reference view's and every source view's."""
    ref, src = (inp[k].clone().requires_grad_(True)
                for k in ("vs_ref", "vs_src"))
    with float64_kept(torch.float64):
        volume = make_view_variance(mesh)(ref, src, inp["vs_rel"],
                                          inp["vs_hyp"])
        g_ref, g_src = torch.autograd.grad(
            (volume * inp["vs_w"]).sum() / mesh.size("view"), (ref, src))
    return dict(volume=volume.detach(), ref_grad=g_ref, src_grad=g_src)


def nested_shared(inp, mesh):
    """collectives.shared over a split volume's sample group (depth x
    space) around shared over 'view', as the models wrap view_variance:
    the same x on every rank, rank r's cotangent (r + 1) x."""
    x = inp["halo_x"]
    xf = x.clone().requires_grad_(True)
    with float64_kept(torch.float64):
        inner = collectives.shared(
            collectives.shared(xf, mesh.group_of(("depth", "space"))),
            mesh.group("view"))
        (g,) = torch.autograd.grad((inner * x * (mesh.rank + 1)).sum(), xf)
    return dict(grad=g)


def forward(inp, mesh, dtype="float32"):
    """The eval-mode forward of MVSNet (inp["fwd_state"]) on the data
    rank's rows of inp["fwd_batch"], the volume split by
    volume_sharded_plan: the depth and confidence rows this rank holds,
    with their row and column slices."""
    dtype = getattr(torch, dtype)
    model = MVSNet(compute_dtype=dtype).to(dtype)
    model.load_state_dict(inp["fwd_state"])
    model.volume_constraint = volume_sharded_plan(mesh).constrain_volume
    batch = _cast(batch_to_device(shard_batch(inp["fwd_batch"], mesh),
                                  "cpu"), dtype)
    model.eval()
    with torch.no_grad(), float64_kept(dtype):
        out = model(batch["imgs"], batch["proj_matrices"],
                    batch["depth_values"])
    shard = out["shard"]
    return dict(depth=out["depth"], conf=out["photometric_confidence"],
                rows=shard.rows, cols=shard.cols)


def halo_case(inp, mesh, spec, p2p=False):
    """The halo exchange and each conv kind on this rank's slab of
    inp["halo_x"] (float64, channels-last (B, D, H, W, C)) under the spec
    inp["halo_specs"][spec]: the outputs and the input gradients of
    sum(out * weight) for each kind, and the regression of inp's scores,
    with the slab's slices."""
    saved = halo.P2P_BACKENDS
    if p2p:  # point-to-point sends over gloo: the NCCL path's logic
        halo.P2P_BACKENDS = ("nccl", "gloo")
    try:
        with float64_kept(torch.float64):
            return _halo_case(inp, mesh, inp["halo_specs"][spec])
    finally:
        halo.P2P_BACKENDS = saved


def _scaled(index, scale):
    return tuple(i if i.start is None else slice(int(i.start * scale),
                                                 int(i.stop * scale))
                 for i in index)


def _halo_case(inp, mesh, spec):
    x = inp["halo_x"]
    shard = sharding._volume_shard(mesh, spec, tuple(x.shape))
    index = shard.slices({1: 1, 2: 2, 3: 3})
    out = {"slices": index}
    xs = shard.take(x).clone().requires_grad_(True)
    ext = halo.extend(xs, shard)
    (g,) = torch.autograd.grad(
        (ext * _ext_weight(inp["halo_w"]["ext"], shard)).sum(), xs)
    out["ext"], out["ext_grad"] = ext.detach(), g
    for name, layer in inp["halo_layers"].items():
        train = name != "fused_eval"
        layer.train(train)
        with sharding.use_volume(shard), torch.set_grad_enabled(train):
            y = layer(xs)
        out[name] = y.detach()
        if train:
            w = inp["halo_w"][name][_scaled(
                index, inp["halo_scale"].get(name, 1))]
            (out[name + "_grad"],) = torch.autograd.grad((y * w).sum(), xs)
    # The softmax and soft-argmin over the split D: each rank's share of
    # sum(depth * w) divided by the ranks holding the same rows.
    scores = shard.take(inp["reg_scores"]).clone().requires_grad_(True)
    depth, conf, prob = collectives.regress_sharded(
        scores, shard.take(inp["reg_hyp"]), shard)
    maps = shard.map_shard()
    (g,) = torch.autograd.grad((depth * maps.take(inp["reg_w"])).sum()
                               / maps.copies, scores)
    out["regress"] = dict(depth=depth.detach(), conf=conf, prob=prob.detach(),
                          grad=g, rows=maps.rows, cols=maps.cols)
    # The features entering the volume: the same x on every rank, rank r's
    # cotangent (r + 1) x, summed over the sample group and divided by its
    # size.
    xf = x.clone().requires_grad_(True)
    (out["shared_grad"],) = torch.autograd.grad(
        (collectives.shared(xf, shard.sample_group) * x
         * (mesh.rank + 1)).sum(), xf)
    return out


def _ext_weight(w, shard):
    """The weights of an extended slab's planes: the global weights at its
    planes (zero past the volume's ends)."""
    pad = torch.nn.functional.pad(w, (0, 0, 1, 1, 1, 1, 1, 1))
    index = [slice(None)] * 5
    for d in (1, 2, 3):
        s = shard.split(d)
        index[d] = slice(s.start, s.stop + 2) if s else slice(1, -1)
    return pad[tuple(index)]


@contextlib.contextmanager
def float64_kept(dtype):
    """In a float64 run, keep .float() from rounding to f32 (the port's
    f32 sums and moments, as the float64 tests read them)."""
    saved = torch.Tensor.float
    if dtype == torch.float64:
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
            else t.to(torch.float32)
    try:
        yield
    finally:
        torch.Tensor.float = saved


def main(inputs, out_dir):
    proc = maybe_initialize_distributed("cpu")
    torch.set_num_threads(1)
    inp = torch.load(inputs, weights_only=False)
    results = {}
    meshes = {}
    for case in inp["cases"]:
        kind, shape, *rest = case
        if shape not in meshes:  # every rank creates the groups in order
            meshes[shape] = make_mesh(**dict(shape))
        mesh = meshes[shape]
        if kind == "primitives":
            results[case] = primitives(inp, mesh)
        elif kind == "forward":
            results[case] = forward(inp, mesh, *rest)
        elif kind == "halo":
            results[case] = halo_case(inp, mesh, *rest)
        elif kind == "view_shared":
            results[case] = view_shared(inp, mesh)
        elif kind == "nested_shared":
            results[case] = nested_shared(inp, mesh)
        else:
            results[case] = train(inp, mesh, *rest)
        results[case]["coords"] = mesh.coords
    out = Path(out_dir)
    torch.save(results, out / f"rank{proc.rank}.pt")
    print(f"rank {proc.rank} done", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])

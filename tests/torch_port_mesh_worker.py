"""One process of the multi-process mesh tests (tests/test_torch_port_mesh*.py):

    SIE_TPU_COORDINATOR=localhost:PORT SIE_TPU_NUM_PROCESSES=N \
    SIE_TPU_PROCESS_ID=i python tests/torch_port_mesh_worker.py SPEC.json

SPEC.json lists scenarios, each a config, a mesh (shape, axes; an
empty shape trains without a mesh, in each process alone), the flax
variables to start from and the rows and schedule (npz files). For each,
every process builds the model from the variables, trains it under
`Trainer(mesh=...)` on the CPU (gloo) through the staged path or
`train_step` on global batches, then gathers the variables
(`to_jax_variables`), evaluates a batch (`eval_step`, every rank's rows),
loads the gathered variables back (sliced again) and evaluates once more.
Process 0 writes `<out>/<name>.npz`: the losses, the gathered variables
("params/..." and "batch_stats/..." keys), the first step's gradients
summed over the mesh, before the clip, gathered to the flax layout
("grads/..."), the eval logits before and after the reload and, for a
MoE model, the load-balance loss of a train-mode forward of the eval
batch ("aux"), and the time widths its training saw ("time_forward",
the widths of the backbone's forwards, `registry.call_dnn`;
"time_halo", those of each `comm.halo_seq` call): under 'seq' a
time-sharded backbone sees its block and takes halos.

A scenario's "device" (default "cpu") is where it trains; the variable
MESH_WORKER_DEVICE names the device the process group starts on (a card
that every process shares, over gloo). A scenario of kind "moe" applies
one MoE layer (`moe` holds its constructor's arguments) in eval mode to
this rank's rows and time block of `x` under the mesh; every process
writes `<out>/<name>_<rank>.npz`: its output block and its 'data' and
'seq' indices. A scenario of kind "pipeline" runs this rank's stage of
an encoder (`cfg`, the flax `Encoder` params in `variables`) through
`parallel.pipeline.pipelined_encoder_apply` on `x` (with `grads`, the
backward of sum(sin(out)) too; with `repeat`, x's first microbatch in
every microbatch's place); every process writes `<out>/<name>_<rank>.npz`:
its output rows, aux, its stage's gradients in the flax layout
("grads/..."), the input's gradient, its 'data' and 'pipe' indices, and
on rank 0 the stages gathered back ("gathered/..."). Imports nothing of
JAX.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_params,  # noqa: E402
                                           load_jax_variables, to_jax_tree,
                                           to_jax_variables)
from sie_tpu_torch.config import Config  # noqa: E402
from sie_tpu_torch.models.registry import build_model  # noqa: E402
from sie_tpu_torch.models.moe import MoEFFN  # noqa: E402
from sie_tpu_torch.models import registry  # noqa: E402
from sie_tpu_torch.models.registry import forward_model  # noqa: E402
from sie_tpu_torch.parallel import comm  # noqa: E402
from sie_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_params  # noqa: E402
from sie_tpu_torch.parallel.multihost import init_distributed  # noqa: E402
from sie_tpu_torch.train.trainer import Trainer  # noqa: E402


def nested(flat) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    out: dict = {}
    for key in flat.files if hasattr(flat, "files") else flat:
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(flat[key])
    return out


def flat(tree, prefix: str) -> dict:
    return {prefix + "/".join(k): v for k, v in _flatten(tree).items()}


def time_probe() -> dict:
    """Records, until `stop()`, the time width of every backbone forward
    (`registry.call_dnn`) and of every `comm.halo_seq` call."""
    seen = {"forward": [], "halo": []}
    fwd, halo = registry.call_dnn, comm.halo_seq

    def call_dnn(dnn, x, padding_mask, generator):
        seen["forward"].append(x.shape[1])
        return fwd(dnn, x, padding_mask, generator)

    def halo_seq(t, before, after, circular, dim=1):
        seen["halo"].append(t.shape[dim])
        return halo(t, before, after, circular, dim)

    def stop():
        registry.call_dnn, comm.halo_seq = fwd, halo
    registry.call_dnn, comm.halo_seq = call_dnn, halo_seq
    seen["stop"] = stop
    return seen


def run_moe(sc: dict, rank: int) -> None:
    mesh = Mesh(sc["mesh_shape"], sc["mesh_axes"])
    layer = MoEFFN(**sc["moe"], dtype=torch.float32,
                   g=torch.Generator().manual_seed(0))
    load_jax_params(layer, nested(np.load(sc["variables"])))
    shard_params(layer, mesh).eval()
    (x,) = shard_batch((np.load(sc["data"])["x"],), mesh)
    with torch.no_grad(), comm.using(mesh):
        y = layer(torch.from_numpy(x))
    np.savez(os.path.join(sc["out"], f"{sc['name']}_{rank}.npz"),
             y=y.numpy(), data=mesh.index("data"), seq=mesh.index("seq"))


def run_pipeline(sc: dict, rank: int) -> None:
    from sie_tpu_torch.compat.from_jax import (gather_stage_params,
                                               load_jax_stage, to_jax_params)
    from sie_tpu_torch.parallel.pipeline import (encoder_stage,
                                                 pipelined_encoder_apply)
    cfg = Config(**sc["cfg"])
    mesh = Mesh(sc["mesh_shape"], sc["mesh_axes"])
    s, n = mesh.index("pipe"), mesh.size("pipe")
    stage = load_jax_stage(encoder_stage(cfg, n), nested(np.load(
        sc["variables"])), s, n)
    x = np.load(sc["data"])["x"]
    m = sc["n_micro"]
    if sc.get("repeat"):
        x = np.concatenate([x[: len(x) // m]] * m)
    xt = torch.from_numpy(x).requires_grad_(bool(sc.get("grads")))
    out = pipelined_encoder_apply(
        cfg, stage, xt, mesh, n_microbatches=m,
        data_axis=sc.get("data_axis"), train=sc.get("train", False),
        generator=torch.Generator().manual_seed(11),
        return_aux=sc.get("return_aux", False))
    out, aux = out if isinstance(out, tuple) else (out, torch.zeros(()))
    extra = {}
    if sc.get("grads"):
        torch.sin(out).sum().backward()
        per = len(stage.layers)
        tree = to_jax_params(stage)
        grads = {k if k == "norm" else f"layer_{s * per + int(k[6:])}": v
                 for k, v in to_jax_tree(stage, {
                     name: p.grad for name, p in stage.named_parameters()
                 }).items()}
        assert set(grads) == {k if k == "norm" else
                              f"layer_{s * per + int(k[6:])}" for k in tree}
        extra.update(flat(grads, "grads/"), xgrad=xt.grad.numpy())
    gathered = gather_stage_params(stage, mesh)
    if rank == 0:
        extra.update(flat(gathered, "gathered/"))
    np.savez(os.path.join(sc["out"], f"{sc['name']}_{rank}.npz"),
             out=out.detach().numpy(), aux=aux.detach().numpy(),
             data=mesh.index("data"), pipe=s, **extra)


def run(sc: dict, rank: int) -> None:
    if sc.get("kind") == "moe":
        return run_moe(sc, rank)
    if sc.get("kind") == "pipeline":
        return run_pipeline(sc, rank)
    cfg = Config(**sc["cfg"])
    data = np.load(sc["data"])
    variables = nested(np.load(sc["variables"]))
    device = sc.get("device", "cpu")
    model = load_jax_variables(build_model(cfg, "cpu"), variables)
    # an empty mesh shape: this process alone, without a mesh
    mesh = Mesh(sc["mesh_shape"], sc["mesh_axes"]) if sc["mesh_shape"] \
        else None
    idx, w, beta = data["idx"], data["w"], float(sc["beta"])
    tr = Trainer(cfg, len(idx), model=model, device=device, mesh=mesh)
    grads = {}
    step = tr.optimizer.device_step

    def spy(position):      # the summed gradients, before the clip
        if not grads:
            grads.update(to_jax_tree(tr.model, dict(zip(
                tr._named(), [p.grad for p in tr.optimizer.params]))))
        return step(position)
    tr.optimizer.device_step = spy
    rows = SimpleNamespace(x=data["x"], y=data["y"],
                           padding_mask=data["mask"])
    losses = []
    seen = time_probe()
    if sc["path"] == "staged":
        dev = tr.device_data("train", rows)
        staged = tr.stage_steps(list(zip(idx, w)), beta)
        for k in range(len(idx)):
            losses.append(float(tr.train_step_staged(dev, staged, k)[0]))
    else:
        for k in range(len(idx)):
            i = idx[k]
            batch = (rows.x[i], rows.y[i], rows.padding_mask[i], w[k])
            losses.append(float(tr.train_step(batch, beta)[0]))
    seen["stop"]()
    out = to_jax_variables(tr.model)
    ev = (rows.x[:8], rows.y[:8], rows.padding_mask[:8], np.ones(8, np.float32))
    extra = {}
    if cfg.moe_experts > 0:
        x, _y, mask, _w = tr._device_batch(ev)
        with torch.no_grad(), comm.using(mesh):
            info = forward_model(tr.model, x, mask)[1]
        extra["aux"] = info.aux_loss.cpu().numpy()
    logits = tr.eval_step(ev)[0].cpu().numpy()
    load_jax_variables(tr.model, out)
    again = tr.eval_step(ev)[0].cpu().numpy()
    if rank == 0:
        np.savez(os.path.join(sc["out"], sc["name"] + ".npz"),
                 losses=np.asarray(losses), logits=logits, again=again,
                 time_forward=np.asarray(seen["forward"], np.int64),
                 time_halo=np.asarray(seen["halo"], np.int64),
                 **flat(grads, "grads/"), **extra,
                 **flat(out["params"], "params/"),
                 **flat(out["batch_stats"], "batch_stats/"))


def main(spec_path: str) -> None:
    device = os.environ.get("MESH_WORKER_DEVICE", "cpu")
    assert init_distributed(device=device) is True
    assert init_distributed(device=device) is True      # idempotent
    import torch.distributed as dist
    torch.manual_seed(0)
    with open(spec_path) as f:
        spec = json.load(f)
    for sc in spec:
        run(sc, dist.get_rank())
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

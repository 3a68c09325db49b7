"""One process of the multi-process mesh tests (tests/test_torch_port_mesh*.py):

    SIE_TPU_COORDINATOR=localhost:PORT SIE_TPU_NUM_PROCESSES=N \
    SIE_TPU_PROCESS_ID=i python tests/torch_port_mesh_worker.py SPEC.json

SPEC.json lists scenarios, each a config, a mesh (shape, axes), the flax
variables to start from and the rows and schedule (npz files). For each,
every process builds the model from the variables, trains it under
`Trainer(mesh=...)` on the CPU (gloo) through the staged path or
`train_step` on global batches, then gathers the variables
(`to_jax_variables`), evaluates a batch (`eval_step`, every rank's rows),
loads the gathered variables back (sliced again) and evaluates once more.
Process 0 writes `<out>/<name>.npz`: the losses, the gathered variables
("params/..." and "batch_stats/..." keys), the eval logits before and
after the reload. Imports nothing of JAX.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_variables,  # noqa: E402
                                           to_jax_variables)
from sie_tpu_torch.config import Config  # noqa: E402
from sie_tpu_torch.models.registry import build_model  # noqa: E402
from sie_tpu_torch.parallel.mesh import Mesh  # noqa: E402
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


def run(sc: dict, rank: int) -> None:
    cfg = Config(**sc["cfg"])
    data = np.load(sc["data"])
    variables = nested(np.load(sc["variables"]))
    model = load_jax_variables(build_model(cfg, "cpu"), variables)
    mesh = Mesh(sc["mesh_shape"], sc["mesh_axes"])
    idx, w, beta = data["idx"], data["w"], float(sc["beta"])
    tr = Trainer(cfg, len(idx), model=model, device="cpu", mesh=mesh)
    rows = SimpleNamespace(x=data["x"], y=data["y"],
                           padding_mask=data["mask"])
    losses = []
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
    out = to_jax_variables(tr.model)
    ev = (rows.x[:8], rows.y[:8], rows.padding_mask[:8], np.ones(8, np.float32))
    logits = tr.eval_step(ev)[0].numpy()
    load_jax_variables(tr.model, out)
    again = tr.eval_step(ev)[0].numpy()
    if rank == 0:
        np.savez(os.path.join(sc["out"], sc["name"] + ".npz"),
                 losses=np.asarray(losses), logits=logits, again=again,
                 **flat(out["params"], "params/"),
                 **flat(out["batch_stats"], "batch_stats/"))


def main(spec_path: str) -> None:
    assert init_distributed(device="cpu") is True
    assert init_distributed(device="cpu") is True      # idempotent
    import torch.distributed as dist
    torch.manual_seed(0)
    with open(spec_path) as f:
        spec = json.load(f)
    for sc in spec:
        run(sc, dist.get_rank())
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

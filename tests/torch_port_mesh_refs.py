"""What the multi-process mesh tests (tests/test_torch_port_mesh_*.py) hold
the port's gloo runs to: the rows and schedule of a small InterpGN run,
the JAX package's single-device Trainer on the global batch (its initial
variables, losses, variables after the first and the last step, and each
step's `jax.grad`), the port's one-process run from the same weights, and
the launch of tests/torch_port_mesh_worker.py processes.

Each run is 3 steps of a global batch of 8, the third holding 4 real rows
and 4 padded ones (weight 0).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from sie_tpu.config import Config as JConfig
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.parallel.multihost import free_port
from sie_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mesh_worker.py")
BASE = dict(model="InterpGN", seq_len=24, enc_in=3, num_class=3,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=1,
            dropout=0.0, amp=False, use_pallas=False,
            fused_attention_min_len=0, lr=5e-3, seed=0, gradient_clip=0.05,
            batch_size=8)
N_ROWS, B, STEPS, BETA = 20, 8, 3, 1.0
# what a worker writes beside the variables and the "grads/..." keys
RUN_OUTPUTS = {"losses", "logits", "again", "time_forward", "time_halo"}


def rows_of(kw):
    rng = np.random.default_rng(7)
    t = kw["seq_len"]
    y = rng.integers(0, kw["num_class"], N_ROWS).astype(np.int32)
    x = (rng.normal(size=(N_ROWS, t, kw["enc_in"]))
         + 0.7 * y[:, None, None]).astype(np.float32)
    mask = np.ones((N_ROWS, t), np.float32)
    mask[::3, (2 * t) // 3:] = 0.0
    order = rng.permutation(N_ROWS)
    idx, w = [], []
    for k in range(STEPS):
        i = order[k * B:(k + 1) * B]
        wk = np.ones(B, np.float32)
        if len(i) < B:        # the padded final batch: rows 4..7 weigh 0
            wk[len(i):] = 0.0
            i = np.concatenate([i, np.zeros(B - len(i), i.dtype)])
        idx.append(i)
        w.append(wk)
    return SimpleNamespace(x=x, y=y, padding_mask=mask,
                           idx=np.stack(idx).astype(np.int64),
                           w=np.stack(w))


def batch_of(rows, k):
    i = rows.idx[k]
    return (rows.x[i], rows.y[i], rows.padding_mask[i], rows.w[k])


def flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v)
            for k, v in _flatten(tree).items()}


def reference(name, kw, root, edit=None):
    """The rows, the JAX initial variables (as a file; `edit(params)` may
    change them first), and the JAX trainer's and the port's one-process
    losses, final variables and each step's JAX gradients."""
    rows = rows_of(kw)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=STEPS)
    state = jt.init_state(batch_of(rows, 0), seed=0)
    if edit is not None:
        state = state.replace(params=edit(state.params))
    init = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    np.savez(root / f"{name}_vars.npz", **flat(init["params"], "params/"),
             **flat(init["batch_stats"], "batch_stats/"))
    np.savez(root / f"{name}_data.npz", x=rows.x, y=rows.y,
             mask=rows.padding_mask, idx=rows.idx, w=rows.w)
    grad_fn = jax.jit(jax.grad(lambda p, s, b: jt.loss_fn(
        p, s, b, jnp.float32(BETA), True, jax.random.key(0))[0]))
    jlosses, grads = [], []
    for k in range(STEPS):
        batch = tuple(jnp.asarray(a) for a in batch_of(rows, k))
        grads.append(flat(jax.tree.map(np.asarray, grad_fn(
            state.params, state.batch_stats, batch))))
        state, loss, _ = jt.train_step(state, batch_of(rows, k), BETA)
        jlosses.append(float(loss))
        if k == 0:
            first = flat({"params": state.params,
                          "batch_stats": state.batch_stats})
    final = flat({"params": state.params, "batch_stats": state.batch_stats})
    cfg = Config(**kw)
    tr = Trainer(cfg, STEPS, model=load_jax_variables(
        build_model(cfg, "cpu"), init), device="cpu")
    plosses = [float(tr.train_step(batch_of(rows, k), BETA)[0])
               for k in range(STEPS)]
    return SimpleNamespace(
        rows=rows, vars=str(root / f"{name}_vars.npz"),
        data=str(root / f"{name}_data.npz"), init=init, kw=kw,
        jax_losses=jlosses, jax_first=first, jax_final=final,
        grads=grads, port_losses=plosses,
        port_final=flat(to_jax_variables(tr.model)))


def scenario(name, ref, shape, axes, path, out):
    """A worker scenario that trains `ref`'s run over the mesh."""
    return dict(name=name, cfg=ref.kw, mesh_shape=list(shape),
                mesh_axes=list(axes), variables=ref.vars, data=ref.data,
                path=path, beta=BETA, out=str(out))


def launch(spec, n, tmp_path, tag):
    """Runs n worker processes on `spec` -> nothing; fails with the logs of
    a worker that failed."""
    launch_together([(spec, n, tag)], tmp_path)


def launch_together(runs, tmp_path):
    """`launch` of several (spec, n, tag) process groups at once, each with
    a coordinator of its own."""
    started = []
    try:
        for spec, n, tag in runs:
            path = tmp_path / f"{tag}.json"
            path.write_text(json.dumps(spec))
            env = {**os.environ,
                   "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
                   "SIE_TPU_NUM_PROCESSES": str(n),
                   "SIE_TPU_BACKEND": "gloo", "OMP_NUM_THREADS": "1"}
            for i in range(n):
                log = open(tmp_path / f"{tag}_{i}.log", "wb")
                started.append((tag, i, log, subprocess.Popen(
                    [sys.executable, WORKER, str(path)],
                    env={**env, "SIE_TPU_PROCESS_ID": str(i)},
                    stdout=log, stderr=subprocess.STDOUT)))
        for *_, p in started:
            p.wait(timeout=300)
    finally:
        for *_, log, p in started:
            if p.poll() is None:
                p.kill()
            log.close()
    for tag, i, _, p in started:
        log = (tmp_path / f"{tag}_{i}.log").read_text()
        assert p.returncode == 0, log[-4000:]


def params_of(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def assert_grads_equal_jax(got, want):
    """The worker's summed first-step gradients ("grads/..." keys) against
    `jax.grad`, leaf by leaf, within 1e-5 x the leaf's max |g|. A leaf
    whose max |g| is below 1e-6 of the tree's is 0 in exact arithmetic
    (a conv bias in front of a BatchNorm, the attention's key bias): its
    values are rounding noise in both packages, held within 1e-5 x the
    tree's max |g|."""
    grads = params_of(got, "grads/")
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, g in grads.items():
        scale = float(np.abs(want[key]).max())
        if scale < 1e-6 * top:
            scale = top
        np.testing.assert_allclose(g, want[key], rtol=0, atol=1e-5 * scale,
                                   err_msg=key)


def assert_trains_like(got, ref, atol):
    """Losses, parameters and batch stats against the JAX trainer's and the
    port's one-process runs, as tests/test_torch_port_mesh_dist.py holds
    them."""
    lr = ref.kw["lr"]
    np.testing.assert_allclose(got["losses"], ref.jax_losses, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["losses"], ref.port_losses, rtol=1e-5,
                               atol=1e-6)
    params = params_of(got, "params/")
    assert set(params) == set(params_of(ref.jax_final, "params/"))
    for want_all in (ref.jax_final, ref.port_final):
        want = params_of(want_all, "params/")
        for key, a in params.items():
            sure = np.all([np.abs(g[key]) >= 1e-4 for g in ref.grads],
                          axis=0)
            np.testing.assert_allclose(a[sure], want[key][sure], rtol=1e-5,
                                       atol=atol, err_msg=key)
            assert np.abs(a - want[key]).max() <= STEPS * 2.1 * lr, key
        stats = params_of(got, "batch_stats/")
        assert set(stats) == set(params_of(want_all, "batch_stats/"))
        for key, a in stats.items():
            b = want_all["batch_stats/" + key]
            assert np.abs(a - b).max() <= STEPS * 2.1 * lr, key


def assert_first_step_like(got, ref, atol):
    """One step from the same weights against the JAX step: the
    parameters whose gradient is >= 1e-4 (rtol 1e-5, `atol`) and every
    BatchNorm buffer (rtol 1e-5, atol 1e-6); every leaf within 2.1 lr."""
    want = ref.jax_first
    assert set(got) - RUN_OUTPUTS - set(
        k for k in got if k.startswith("grads/")) == set(want)
    for key, b in want.items():
        param = key.startswith("params/")
        sure = (np.abs(ref.grads[0][key[len("params/"):]]) >= 1e-4 if param
                else np.ones(b.shape, bool))
        np.testing.assert_allclose(got[key][sure], b[sure], rtol=1e-5,
                                   atol=atol if param else 1e-6, err_msg=key)
        assert np.abs(got[key] - b).max() <= 2.1 * ref.kw["lr"], key


def assert_time_blocks(got, seq_len, s, halos_a_forward):
    """Every backbone forward of the worker's training saw a time block of
    seq_len / s steps (the whole T where s is 1), and took
    `halos_a_forward` halos of such blocks each."""
    n = seq_len // s
    forwards = got["time_forward"]
    assert len(forwards) == STEPS and set(forwards.tolist()) == {n}
    assert got["time_halo"].tolist() == [n] * (halos_a_forward * STEPS)


def jax_logits(got, kw, rows):
    """The JAX model's eval logits on the first 8 rows from the worker's
    gathered variables."""
    from sie_tpu.models import build_model as jax_build_model
    variables = {}
    for key, v in got.items():
        if key.startswith(("params/", "batch_stats/")):
            node = variables
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    if not variables.get("batch_stats"):
        variables.pop("batch_stats", None)
    model = jax_build_model(JConfig(**kw))
    logits, _ = model.apply(variables, jnp.asarray(rows.x[:8]),
                            jnp.asarray(rows.padding_mask[:8]), train=False)
    return np.asarray(logits)

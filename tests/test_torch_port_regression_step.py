"""One CRPS train step of the regression model in both packages, on the
CPU, from the same weights: does the port move its logits as the JAX
package does, saturating where it saturates?

InterpGN + Transformer on BIDMC32HR's shape after x4 subsampling (T 1000,
2 channels), 10 bins, 2 rows from a numpy seed. The JAX
`Trainer(loss_head=make_crps_head)` initialises the weights; the port's
`Trainer` takes them through `load_jax_params`. Each takes one step at lr
5e-3, then both evaluate the 2 rows. Limit on the gap between the
packages: 5e-2 x the largest logit with amp (bf16 rounding at other
places; the limit of chip_smoke.py's trained regression check), 1e-3 x it
in f32.

The test runs it at a narrow width (d_model 32, T 200). The full width of
chip_smoke.py's regression phase (d_model 512, d_ff 2048, 8 heads, 2
layers, six banks of 10, T 1000) takes minutes on the CPU:

    python tests/test_torch_port_regression_step.py [--lr 5e-3] [--no-amp]

prints the logits before and after the step, their largest magnitude and
the gap against the limit, and exits 1 above it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sie_tpu.config import Config as JConfig  # noqa: E402
from sie_tpu.train.regression import make_crps_head as jax_crps  # noqa: E402
from sie_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from sie_tpu_torch.compat.from_jax import load_jax_params  # noqa: E402
from sie_tpu_torch.config import Config  # noqa: E402
from sie_tpu_torch.models.registry import build_model  # noqa: E402
from sie_tpu_torch.train.regression import make_crps_head  # noqa: E402
from sie_tpu_torch.train.trainer import Trainer  # noqa: E402

# ten bin edges over heart rates (beats a minute), the last one open
EDGES = np.array([55.0, 62.0, 68.0, 73.0, 78.0, 83.0, 89.0, 96.0, 105.0,
                  np.inf])


FULL = dict(seq_len=1000, num_shapelet=10, d_model=512, d_ff=2048,
            n_heads=8, e_layers=2)
NARROW = dict(seq_len=200, num_shapelet=2, d_model=32, d_ff=64, n_heads=2,
              e_layers=1)


def one_step(width: dict, lr: float, amp: bool):
    """{"before": (port, JAX logits), "after": (...), "loss": (port, JAX)}
    of one CRPS step from the JAX package's initial weights."""
    kw = dict(model="InterpGN", dnn_type="Transformer", enc_in=2,
              num_class=len(EDGES), dropout=0.0, amp=amp, lr=lr,
              use_pallas=False, seed=0, **width)
    t = kw["seq_len"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, t, 2)).astype(np.float32)
    y = np.array([71.5, 92.0], np.float32)
    batch = (x, y, np.ones((2, t), np.float32), np.ones(2, np.float32))

    jt = JTrainer(JConfig(**kw), steps_per_epoch=1,
                  loss_head=jax_crps(EDGES))
    state = jt.init_state(batch, seed=0)
    apply = jax.jit(lambda params: jt.model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(batch[2]),
        train=False)[0])
    j_before = np.asarray(apply(state.params))
    params = jax.tree.map(np.asarray, state.params)   # the step donates
    new_state, jloss, _ = jt.train_step(state, batch, 1.0)
    j_after = np.asarray(apply(new_state.params))

    model = load_jax_params(build_model(Config(**kw), "cpu"), params)
    tr = Trainer(Config(**kw), steps_per_epoch=1, model=model, device="cpu",
                 loss_head=make_crps_head(EDGES))
    t_before = tr.eval_step(batch)[0].float().numpy()
    tloss, _ = tr.train_step(batch, 1.0)
    t_after = tr.eval_step(batch)[0].float().numpy()
    return {"before": (t_before, j_before), "after": (t_after, j_after),
            "loss": (float(tloss), float(jloss))}


def within(got: np.ndarray, want: np.ndarray, amp: bool) -> bool:
    return np.abs(got - want).max() <= (5e-2 if amp else 1e-3) * \
        np.abs(want).max()


@pytest.mark.parametrize("amp", [False, True])
def test_one_step_at_lr_5e3_moves_the_logits_alike(amp):
    """At lr 5e-3 one Adam step moves each of the head's many inputs by
    ~lr in both packages, so the logits grow by orders of magnitude in
    both (the saturation seen at full width), and they agree."""
    out = one_step(NARROW, 5e-3, amp)
    for tag in ("before", "after"):
        assert within(*out[tag], amp), tag
    grow = lambda pair: np.abs(pair[1]).max() / np.abs(out["before"][1]).max()
    assert grow(out["after"]) > 10


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--amp", action=argparse.BooleanOptionalAction,
                   default=True)
    args = p.parse_args(argv)
    out = one_step(FULL, args.lr, args.amp)
    rel = 5e-2 if args.amp else 1e-3
    for tag in ("before", "after"):
        a, b = out[tag]
        big = float(np.abs(b).max())
        gap = float(np.abs(a - b).max())
        print(f"{tag} the step: max |logit| JAX {big:.6f}, port "
              f"{float(np.abs(a).max()):.6f}; max gap {gap:.6e} (limit "
              f"{rel} x {big:.6f} = {rel * big:.6e})")
    print(f"lr {args.lr}, amp {args.amp}: loss JAX {out['loss'][1]:.6f}, "
          f"port {out['loss'][0]:.6f}")
    print("JAX logits after:", np.array2string(out["after"][1], precision=4))
    print("port logits after:", np.array2string(out["after"][0],
                                                 precision=4))
    return 0 if all(within(*out[t], args.amp) for t in ("before", "after")) \
        else 1


if __name__ == "__main__":
    sys.exit(main())

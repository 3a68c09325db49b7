"""The BatchNorm backbones through the port's experiment and command line,
against the JAX package, on the CPU.

InterpGN + FCN, as `run_uea.sh` runs it (f32, its shapelet flags) but
tiny: 2 shapelets on a synthetic UEA set of 3 dimensions x 30 steps. The
port's `Experiment` starts from the JAX `Experiment`'s initial variables
(parameters and batch_stats) and both train 2 epochs (6 steps): per epoch
the train losses within 1e-4 (the limit of
tests/test_torch_port_experiment.py), the same validation accuracy and
early-stopping decisions. The FCN's conv biases stand in front of a
BatchNorm, so their gradient is 0 in exact arithmetic: Adam moves them by
~lr a step in the direction of rounding noise, which differs between the
packages. Training reads batch statistics, which cancel them; eval reads
the running mean, which absorbs a tenth of a step's move. So those biases
are held within 2 x lr a step and every other parameter within 2.1 x lr
(Adam's limit in tests/test_torch_port_train.py), and the eval numbers
that they shift, the validation losses within 2e-3 and the test logits
within 1e-2, after measured differences of 4e-4 and 4.6e-3. Each best
checkpoint holds the batch_stats under the flax names and gives the other
package the writer's test logits within 1e-5 (one f32 forward).
`python -m sie_tpu_torch.run --device cpu` with `--dnn_type FCN` and with
`--model EEGCNN` trains, writes a checkpoint with non-empty batch_stats,
and a re-run skips training at the same test accuracy."""

import re

import jax
import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.train.experiment import Experiment as JExperiment
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import load_jax_variables, port_layout
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.train import checkpoint as pckpt
from sie_tpu_torch.train.experiment import Experiment

KW = dict(data="UEA", dataset="Toy", model="InterpGN", dnn_type="FCN",
          num_shapelet=2, lambda_div=0.1, lambda_reg=0.1, epsilon=1.0,
          gating_value=1.0, dropout=0.0, amp=False, use_pallas=False,
          batch_size=8, lr=5e-3, train_epochs=2, patience=5, log_interval=1,
          seed=0)


def _bn_names(stats):
    """The flax BatchNorm scopes of a batch_stats tree, as paths."""
    out = []
    for k, v in stats.items():
        if set(v) == {"mean", "var"}:
            out.append(k)
        else:
            out += [f"{k}/{n}" for n in _bn_names(v)]
    return sorted(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn_exp")
    write_synthetic_uea(str(tmp / "uea"), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    kw = dict(KW, data_root=str(tmp / "uea"), cache_dir=str(tmp / "cache"),
              result_dir=str(tmp / "result"))
    jrec, prec = [], []
    jexp = JExperiment(JConfig(**kw, checkpoint_dir=str(tmp / "jck")),
                       verbose=False, metrics_hook=jrec.append)
    jexp._init_state()
    pexp = Experiment(Config(**kw, checkpoint_dir=str(tmp / "pck")),
                      verbose=False, metrics_hook=prec.append, device="cpu")
    load_jax_variables(pexp.trainer.model, jax.tree.map(np.asarray, {
        "params": jexp.state.params,
        "batch_stats": jexp.state.batch_stats}))
    jexp.train()
    pexp.train()
    return jexp, pexp, jrec, prec, kw, tmp


def test_epochs_match_the_jax_experiment(runs):
    jexp, pexp, jrec, prec, _kw, _tmp = runs
    assert len(jrec) == len(prec) == KW["train_epochs"]
    for j, p in zip(jrec, prec):
        assert p["train_loss"] == pytest.approx(j["train_loss"], abs=1e-4)
        assert p["val_loss"] == pytest.approx(j["val_loss"], abs=2e-3)
        assert p["val_accuracy"] == j["val_accuracy"]
    assert pexp.epoch_stop == jexp.epoch_stop
    model = pexp.trainer.model
    want = port_layout(model, jax.tree.map(np.asarray, jexp.state.params))
    steps = KW["train_epochs"] * len(pexp.train_loader)
    for name, p in model.named_parameters():
        pre_bn = re.fullmatch(r"deep_model\.conv\d\.bias", name)
        limit = (2 * steps if pre_bn else 2.1) * KW["lr"]
        assert np.abs(p.detach().numpy() - want[name]).max() <= limit, name


def test_best_checkpoints_hold_batch_stats_and_cross(runs):
    jexp, pexp, _jrec, _prec, kw, tmp = runs
    want = ["deep_model/bn1", "deep_model/bn2", "deep_model/bn3"]
    stats = pckpt.load_checkpoint(pexp.checkpoint_dir)["batch_stats"]
    assert _bn_names(stats) == want
    jlogits = np.asarray(jexp.test(save_csv=False)[2].preds)
    plogits = np.asarray(pexp.test(save_csv=False)[2].preds)
    assert np.abs(plogits - jlogits).max() <= 1e-2
    p2 = Experiment(Config(**kw, checkpoint_dir=str(tmp / "jck")),
                    verbose=False, device="cpu")
    assert p2.load_checkpoint()
    assert np.abs(np.asarray(p2.test(save_csv=False)[2].preds)
                  - jlogits).max() <= 1e-5
    j2 = JExperiment(JConfig(**kw, checkpoint_dir=str(tmp / "pck")),
                     verbose=False)
    assert j2.load_checkpoint()
    assert np.abs(np.asarray(j2.test(save_csv=False)[2].preds)
                  - plogits).max() <= 1e-5


def _accuracy(text):
    return re.search(r"Test accuracy (\S+)%", text).group(1)


CLI = {
    "uea_fcn": ["--data", "UEA", "--dataset", "Toy", "--model", "InterpGN",
                "--dnn_type", "FCN", "--no-amp", "--num_shapelet", "2",
                "--lambda_div", "0.1", "--lambda_reg", "0.1", "--epsilon",
                "1", "--gating_value", "1", "--batch_size", "8"],
    "eegcnn": ["--data", "EEG3", "--max_files", "4", "--target_channels",
               "8", "--target_timepoints", "200", "--model", "EEGCNN",
               "--d_model", "16", "--eegcnn_cnn_f1", "4", "--eegcnn_cnn_f2",
               "2", "--eegcnn_n_heads", "2", "--eegcnn_d_ff", "16",
               "--eegcnn_kernel1", "16", "--batch_size", "8"],
}
BN = {"uea_fcn": ["deep_model/bn1", "deep_model/bn2", "deep_model/bn3"],
      "eegcnn": ["eegcnn/block1_bn1", "eegcnn/block1_bn2",
                 "eegcnn/block2_bn"]}


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_trains_checkpoints_and_skips(case, tmp_path, capsys):
    write_synthetic_uea(str(tmp_path / "uea"), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    root = tmp_path / ("uea" if case == "uea_fcn" else "no_chisco")
    argv = ["--device", "cpu", *CLI[case], "--data_root", str(root),
            "--train_epochs", "2", "--patience", "3", "--log_interval", "1",
            "--seed", "0", "--checkpoint_dir", str(tmp_path / "ck"),
            "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    port_run.main(argv)
    first = capsys.readouterr().out
    assert len(re.findall(r"Epoch \d/2 \| Train Loss", first)) == 2
    (res,) = port_run.main(argv)
    again = capsys.readouterr().out
    assert "checkpoint exists — skipping training" in again
    assert "Epoch" not in again
    assert _accuracy(again) == _accuracy(first)
    cfg = port_run.args_to_config(port_run.get_args(argv), 0)
    ck = tmp_path / "ck" / cfg.checkpoint_key()
    stats = pckpt.load_checkpoint(str(ck))["batch_stats"]
    assert _bn_names(stats) == BN[case]
    assert any(np.abs(v["mean"]).max() > 0 for v in
               (stats["deep_model"] if case == "uea_fcn" else
                stats["eegcnn"]).values())
    assert res[0] == 0

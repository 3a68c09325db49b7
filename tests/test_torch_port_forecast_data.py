"""The port's forecasting, M4 and anomaly data (read with the `csv`
module and numpy) against the JAX package's (read with pandas), on the
CPU: the same files through both give equal arrays (`np.array_equal`),
field by field. Also the forecast metrics and losses (float64 / f32
arithmetic in the same order: 1e-6 relative) and the causal mask."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.data import anomaly as janomaly
from sie_tpu.data import forecast as jforecast
from sie_tpu.data import loader as jloader
from sie_tpu.data import m4 as jm4
from sie_tpu.data.provider import data_provider as jax_provider
from sie_tpu.utils import losses as jlosses
from sie_tpu.utils import masking as jmasking
from sie_tpu.utils import metrics as jmetrics
from sie_tpu.utils import timefeatures as jtf
from sie_tpu.utils.m4_summary import M4Summary as JM4Summary
from sie_tpu_torch.config import Config
from sie_tpu_torch.data import anomaly as panomaly
from sie_tpu_torch.data import forecast as pforecast
from sie_tpu_torch.data import loader as ploader
from sie_tpu_torch.data import m4 as pm4
from sie_tpu_torch.data.provider import data_provider
from sie_tpu_torch.data.synthetic import write_synthetic_ett
from sie_tpu_torch.utils import losses as plosses
from sie_tpu_torch.utils import masking as pmasking
from sie_tpu_torch.utils import metrics as pmetrics
from sie_tpu_torch.utils import timefeatures as ptf
from sie_tpu_torch.utils.m4_summary import M4Summary

SIZE = (24, 8, 12)
# rows enough for every ETT border: 20 months of 30 days
KINDS = {"ETTh": (20 * 30 * 24, 60), "ETTm": (20 * 30 * 24 * 4, 15),
         "custom": (500, 1440)}


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("forecast")
    paths = {}
    for kind, (n, minutes) in KINDS.items():
        paths[kind] = write_synthetic_ett(
            str(root / f"{kind}.csv"), n_rows=n, step_minutes=minutes,
            seed=len(kind))
    return paths


def _equal(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


@pytest.mark.parametrize("features", ["M", "S", "MS"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forecast_loader_equals_jax(csvs, kind, features):
    freq = "t" if kind == "ETTm" else "h"
    for flag in ("train", "val", "test"):
        kw = dict(flag=flag, size=SIZE, features=features, target="OT",
                  freq=freq, dataset_kind=kind)
        j = jforecast.load_forecast_csv(csvs[kind], **kw)
        p = pforecast.load_forecast_csv(csvs[kind], **kw)
        for field in ("data", "stamp", "mean", "std"):
            _equal(getattr(j, field), getattr(p, field))
        assert len(j) == len(p) > 0
        for i in (0, len(j) - 1):
            for a, b in zip(j[i], p[i]):
                _equal(a, b)
        # --inverse undoes the train-fitted scaling the same way
        _equal(j.inverse_transform(j.data[:5]), p.inverse_transform(p.data[:5]))
    unscaled = pforecast.load_forecast_csv(csvs[kind], scale=False, **kw)
    assert unscaled.mean is None and \
        unscaled.inverse_transform(unscaled.data) is unscaled.data


def test_dates_in_another_format_raise(tmp_path):
    path = tmp_path / "slash.csv"
    path.write_text("when,OT\n07/01/2016 00:00,1.0\n07/01/2016 01:00,2.0\n")
    with pytest.raises(ValueError, match="'when'"):
        pforecast.load_forecast_csv(str(path), size=(1, 0, 1))
    day = tmp_path / "day.csv"
    day.write_text("date,OT\n2016-07-01,1.0\n2016-07-02,2.0\n")
    p = pforecast.load_forecast_csv(str(day), size=(1, 0, 1), freq="d",
                                    scale=False)
    j = jforecast.load_forecast_csv(str(day), size=(1, 0, 1), freq="d",
                                    scale=False)
    _equal(j.stamp, p.stamp)


@pytest.mark.parametrize("freq", sorted(jtf._FREQ_FEATURES))
def test_time_features_equal_pandas(freq):
    """Across ISO week 53 of 2020 (2020-12-28 ... 2021-01-03 is week 53,
    2021-01-04 week 1) and the leap day 2020-02-29, every second field
    of the hour included."""
    idx = pd.DatetimeIndex(np.concatenate([
        pd.date_range("2020-12-27 22:59:31", "2021-01-05 01:00:00",
                      freq="4567s").to_numpy(),
        pd.date_range("2020-02-27", "2020-03-02", freq="37min").to_numpy(),
        pd.date_range("2019-12-28", "2021-01-04", freq="D").to_numpy()]))
    want = jtf.time_features(idx, freq)
    got = ptf.time_features(idx.to_numpy(), freq)
    assert got.dtype == np.float32
    _equal(want, got)
    weeks = ptf.isoweek(np.array(["2020-12-28", "2021-01-03", "2021-01-04"],
                                 "datetime64[s]"))
    _equal(weeks, [53, 53, 1])


def _m4_csvs(root, group, n, train_len, horizon, seed):
    """M4-format CSVs written by pandas, values with 2 decimals as the
    published files have them; series i is i values shorter (ragged
    rows end in empty cells)."""
    rng = np.random.default_rng(seed)
    tr = {"V1": [f"{group[0]}{i}" for i in range(n)]}
    te = {"V1": list(tr["V1"])}
    for j in range(train_len):
        col = np.round(rng.uniform(10, 20, n), 2)
        col[train_len - j <= np.arange(n)] = np.nan
        tr[f"V{j + 2}"] = col
    for j in range(horizon):
        te[f"V{j + 2}"] = np.round(rng.uniform(10, 20, n), 2)
    paths = (os.path.join(root, f"{group}-train.csv"),
             os.path.join(root, f"{group}-test.csv"))
    pd.DataFrame(tr).to_csv(paths[0], index=False)
    pd.DataFrame(te).to_csv(paths[1], index=False)
    return paths


@pytest.mark.parametrize("layout", ["npz", "pair", "single"])
def test_m4_layouts_equal_jax(tmp_path, layout):
    root = str(tmp_path)
    paths = _m4_csvs(root, "Monthly", 5, 40, 18, 0)
    if layout == "npz":
        cache = os.path.join(root, "cache")
        jm4.build_m4_cache({"Monthly": paths}, os.path.join(root, "jcache"))
        pm4.build_m4_cache({"Monthly": paths}, cache)
        # the port's cache reads in the JAX package, and the reverse
        for a, b in ((cache, os.path.join(root, "jcache")),
                     (os.path.join(root, "jcache"), cache)):
            j = jm4.M4Dataset.load(training=False, dataset_file=a)
            p = pm4.M4Dataset.load(training=False, dataset_file=b)
            _equal(j.groups, p.groups)
            _equal(j.frequencies, p.frequencies)
            _equal(j.horizons, p.horizons)
            for u, v in zip(j.values, p.values):
                _equal(u, v)
        root = cache
    elif layout == "single":
        os.replace(paths[0], os.path.join(root, "Monthly.csv"))
    for flag in (("train",) if layout == "single" else ("train", "test")):
        j = jforecast.load_m4(root, "Monthly", 30, 18, flag)
        p = pforecast.load_m4(root, "Monthly", 30, 18, flag)
        assert len(j) == len(p) == 5
        for i in range(5):
            for a, b in zip(j[i], p[i]):
                _equal(a, b)
    if layout == "single":
        with pytest.raises(FileNotFoundError):
            pforecast.load_m4(root, "Monthly", 30, 18, "test")


def test_m4_summary_equals_jax(tmp_path):
    root = str(tmp_path)
    groups = {"Yearly": 6, "Monthly": 18, "Hourly": 48}
    csvs = {g: _m4_csvs(root, g, 3, 60, h, i)
            for i, (g, h) in enumerate(groups.items())}
    pm4.build_m4_cache(csvs, root)
    rng = np.random.default_rng(9)
    naive = {"id": [f"{g[0]}{i}" for g in groups for i in range(3)]}
    for j in range(48):
        naive[f"V{j + 1}"] = [round(rng.uniform(10, 20), 2) if j < h
                              else np.nan
                              for h in groups.values() for _ in range(3)]
    pd.DataFrame(naive).to_csv(os.path.join(root, "submission-Naive2.csv"),
                               index=False)
    fdir = tmp_path / "fc"
    fdir.mkdir()
    for g, h in groups.items():
        pd.DataFrame(np.round(rng.uniform(10, 20, (3, h)), 2)).to_csv(
            fdir / f"{g}_forecast.csv", index=False)
    got = M4Summary(str(fdir), root).evaluate()
    assert got == JM4Summary(str(fdir), root).evaluate()
    assert all(np.isfinite(v) for d in got for v in d.values())


@pytest.mark.parametrize("layout", ["npy", "psm_csv"])
def test_anomaly_layouts_equal_jax(tmp_path, layout):
    rng = np.random.default_rng(3)
    train, test = rng.normal(size=(530, 6)), rng.normal(size=(330, 6))
    labels = (rng.uniform(size=330) < 0.1).astype(np.float32)
    if layout == "npy":
        np.save(tmp_path / "SMD_train.npy", train)
        np.save(tmp_path / "SMD_test.npy", test)
        np.save(tmp_path / "SMD_test_label.npy", labels)
        name = "SMD"
    else:
        name = "PSM"
        for f, arr in (("train", train), ("test", test)):
            df = pd.DataFrame(arr, columns=[f"feature_{i}" for i in range(6)])
            df.insert(0, "timestamp_(min)", np.arange(len(arr)) * 1.0)
            df["note"] = "x"                         # not a number: dropped
            df.loc[3, "feature_2"] = np.nan          # missing: 0
            df.to_csv(tmp_path / f"{f}.csv", index=False)
        pd.DataFrame({"label": labels}).to_csv(tmp_path / "test_label.csv",
                                               index=False)
    for flag in ("train", "test"):
        j = janomaly.load_segments(str(tmp_path), name, flag, win_size=50)
        p = panomaly.load_segments(str(tmp_path), name, flag, win_size=50)
        _equal(j.values, p.values)
        assert (j.labels is None) == (p.labels is None)
        if j.labels is not None:
            _equal(j.labels, p.labels)
        assert len(j) == len(p) and p.step == j.step
        for a, b in zip(j[len(j) - 1], p[len(p) - 1]):
            _equal(a, b)


@pytest.mark.parametrize("shuffle,epoch", [(True, 0), (True, 1), (False, 0)])
def test_indexed_batcher_equal(shuffle, epoch):
    rng = np.random.default_rng(4)
    ds = jforecast.ForecastDataset(rng.normal(size=(90, 3)).astype(np.float32),
                                   rng.normal(size=(90, 4)).astype(np.float32),
                                   12, 4, 6)
    jb = jloader.IndexedBatcher(ds, 7, shuffle, seed=5)
    pb = ploader.IndexedBatcher(ds, 7, shuffle, seed=5)
    assert len(jb) == len(pb) == len(ds) // 7
    for a, b in zip(jb.epoch(epoch), pb.epoch(epoch)):
        for u, v in zip(a, b):
            _equal(u, v)


@pytest.mark.parametrize("data", ["ETTh1", "custom", "m4", "SMD"])
def test_provider_routes_like_jax(tmp_path, data, csvs):
    root = str(tmp_path)
    if data in ("ETTh1", "custom"):
        os.symlink(csvs["ETTh" if data == "ETTh1" else "custom"],
                   os.path.join(root, "set.csv"))
    elif data == "m4":
        _m4_csvs(root, "Monthly", 9, 40, 18, 2)
    else:
        rng = np.random.default_rng(5)
        np.save(tmp_path / "SMD_train.npy", rng.normal(size=(500, 4)))
        np.save(tmp_path / "SMD_test.npy", rng.normal(size=(300, 4)))
        np.save(tmp_path / "SMD_test_label.npy", np.zeros(300, np.float32))
    kw = dict(data=data, data_root=root, dataset="set", seq_len=24,
              label_len=8, pred_len=12, batch_size=4, seed=3)
    for flag in ("train", "test"):
        _jds, jb = jax_provider(JConfig(**kw), flag)
        _pds, pb = data_provider(Config(**kw), flag)
        assert type(pb).__name__ == "IndexedBatcher"
        assert len(jb) == len(pb) > 0
        for a, b in zip(next(iter(jb)), next(iter(pb))):
            _equal(a, b)


def test_metrics_and_losses_equal_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(5, 12, 3)).astype(np.float32)
    true = rng.normal(size=(5, 12, 3)).astype(np.float32)
    for name in ("RSE", "CORR", "MAE", "MSE", "RMSE", "MAPE", "MSPE"):
        np.testing.assert_allclose(getattr(pmetrics, name)(pred, true),
                                   getattr(jmetrics, name)(pred, true),
                                   rtol=1e-6)
    true[0, :4] = 0.0            # zero targets: _div_no_nan's zeros
    fc = pred.copy()
    fc[0, :2] = 0.0              # and 0/0
    ins = rng.normal(size=(5, 30)).astype(np.float32)
    ins[1] = 1.0                 # a flat history: masep 0
    for name, args in (("mape_loss", (fc, true)), ("smape_loss", (fc, true)),
                       ("mase_loss", (ins, 3, fc[..., 0], true[..., 0]))):
        want = float(getattr(jlosses, name)(*(jnp.asarray(a) if
                                              isinstance(a, np.ndarray)
                                              else a for a in args)))
        got = float(getattr(plosses, name)(*(torch.from_numpy(a) if
                                             isinstance(a, np.ndarray)
                                             else a for a in args)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    _equal(np.asarray(jmasking.triangular_causal_mask(2, 5)),
           pmasking.triangular_causal_mask(2, 5).numpy())

"""M4 evaluation summary (counterpart of sie_tpu/utils/m4_summary.py):
sMAPE, MAPE and MASE per seasonal group, the M4 regrouping (Yearly,
Quarterly and Monthly kept, Weekly + Daily + Hourly pooled as 'Others',
a count-weighted Average) and OWA against the Naive2 submission. The
forecast and Naive2 CSVs are read with the `csv` module."""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from sie_tpu_torch.data.m4 import M4Dataset, M4Meta
from sie_tpu_torch.data.table import column_matrix, read_table


def group_values(values: np.ndarray, groups: np.ndarray, name: str):
    return [np.asarray(v)[~np.isnan(np.asarray(v, dtype=float))]
            for v in values[groups == name]]


def mase(forecast, insample, outsample, frequency: int) -> float:
    """Mean absolute scaled error: MAE of the forecast over the MAE of the
    seasonal-naive in-sample differences."""
    scale = np.mean(np.abs(np.asarray(insample)[:-frequency]
                           - np.asarray(insample)[frequency:]))
    return float(np.mean(np.abs(np.asarray(forecast)
                                - np.asarray(outsample))) / scale)


def smape_2(forecast, target) -> np.ndarray:
    """Symmetric MAPE (M4 definition, 0..200). Zero denominators divide by 1
    (the numerator is then 0 anyway)."""
    f, t = np.asarray(forecast, float), np.asarray(target, float)
    denom = np.abs(t) + np.abs(f)
    denom = np.where(denom == 0.0, 1.0, denom)
    return 200.0 * np.abs(f - t) / denom


def mape(forecast, target) -> np.ndarray:
    f, t = np.asarray(forecast, float), np.asarray(target, float)
    denom = np.abs(t)
    denom = np.where(denom == 0.0, 1.0, denom)
    return 100.0 * np.abs(f - t) / denom


def _read_matrix(path: str, first: int = 0) -> np.ndarray:
    """The CSV's numbers from column `first` on, float64, missing = NaN."""
    header, rows = read_table(path)
    return column_matrix(rows, range(first, len(header)))


class M4Summary:
    """forecast_dir holds '{group}_forecast.csv' files (one row per
    series); root_path holds the M4 cache and 'submission-Naive2.csv'."""

    def __init__(self, forecast_dir: str, root_path: str):
        self.forecast_dir = forecast_dir
        self.training_set = M4Dataset.load(training=True, dataset_file=root_path)
        self.test_set = M4Dataset.load(training=False, dataset_file=root_path)
        self.naive_path = os.path.join(root_path, "submission-Naive2.csv")

    def evaluate(self):
        """(smape, owa, mape, mase) dicts grouped by the M4 rules."""
        naive2 = _read_matrix(self.naive_path, first=1)
        naive2 = np.asarray([row[~np.isnan(row)] for row in naive2],
                            dtype=object)

        model_mases, naive2_smapes, naive2_mases = {}, {}, {}
        grouped_smapes, grouped_mapes = {}, {}
        for group in M4Meta.seasonal_patterns:
            path = os.path.join(self.forecast_dir, f"{group}_forecast.csv")
            if not os.path.exists(path):
                continue
            model_fc = _read_matrix(path)
            sel = self.test_set.groups == group
            naive_fc = group_values(naive2, self.test_set.groups, group)
            target = group_values(self.test_set.values, self.test_set.groups,
                                  group)
            insample = group_values(self.training_set.values,
                                    self.test_set.groups, group)
            freq = int(self.training_set.frequencies[sel][0])

            model_mases[group] = float(np.mean(
                [mase(model_fc[i], insample[i], target[i], freq)
                 for i in range(len(model_fc))]))
            naive2_mases[group] = float(np.mean(
                [mase(naive_fc[i], insample[i], target[i], freq)
                 for i in range(len(model_fc))]))
            naive2_smapes[group] = float(np.mean(np.concatenate(
                [smape_2(naive_fc[i], target[i]) for i in range(len(model_fc))])))
            grouped_smapes[group] = float(np.mean(np.concatenate(
                [smape_2(model_fc[i], target[i]) for i in range(len(model_fc))])))
            grouped_mapes[group] = float(np.mean(np.concatenate(
                [mape(model_fc[i], target[i]) for i in range(len(model_fc))])))

        grouped_smapes = self.summarize_groups(grouped_smapes)
        grouped_mapes = self.summarize_groups(grouped_mapes)
        grouped_mases = self.summarize_groups(model_mases)
        naive2_smapes = self.summarize_groups(naive2_smapes)
        naive2_mases = self.summarize_groups(naive2_mases)
        owa = OrderedDict(
            (k, (grouped_mases[k] / naive2_mases[k]
                 + grouped_smapes[k] / naive2_smapes[k]) / 2)
            for k in grouped_mases)

        rnd = lambda d: {k: float(np.round(v, 3)) for k, v in d.items()}
        return (rnd(grouped_smapes), rnd(owa), rnd(grouped_mapes),
                rnd(grouped_mases))

    def summarize_groups(self, scores: dict) -> OrderedDict:
        """Yearly, Quarterly and Monthly individually, the sub-monthly
        groups pooled as 'Others', a count-weighted 'Average'."""
        out = OrderedDict()
        count = lambda g: int(np.sum(self.test_set.groups == g))
        weighted = {}
        total = 0
        for g in ("Yearly", "Quarterly", "Monthly"):
            if g in scores:
                weighted[g] = scores[g] * count(g)
                out[g] = scores[g]
                total += count(g)
        others_score = others_count = 0
        for g in ("Weekly", "Daily", "Hourly"):
            if g in scores:
                others_score += scores[g] * count(g)
                others_count += count(g)
        if others_count:
            weighted["Others"] = others_score
            out["Others"] = others_score / others_count
            total += others_count
        if not total:
            raise FileNotFoundError(
                "no per-group forecasts found to summarize — check that "
                "'{group}_forecast.csv' files exist in the forecast dir")
        out["Average"] = float(np.sum(list(weighted.values())) / total)
        return out

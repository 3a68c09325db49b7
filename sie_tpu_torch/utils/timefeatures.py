"""Calendar time features (counterpart of sie_tpu/utils/timefeatures.py,
gluonts-derived), computed from numpy datetime64 arrays instead of a
pandas DatetimeIndex. Each field equals the pandas one: hour, minute,
second, day of week (Monday 0), day of month, day of year, month and the
ISO-8601 week (the week of the year in which the date's Thursday falls).
Each feature is scaled to [-0.5, 0.5] as there."""

from __future__ import annotations

import numpy as np


def _days(d: np.ndarray) -> np.ndarray:
    return d.astype("datetime64[D]")


def _field(d: np.ndarray, fine: str, coarse: str) -> np.ndarray:
    """Whole `fine` units from the start of the `coarse` unit containing d."""
    return (d.astype(f"datetime64[{fine}]")
            - d.astype(f"datetime64[{coarse}]")).astype(np.int64)


def second(d):
    return _field(d, "s", "m")


def minute(d):
    return _field(d, "m", "h")


def hour(d):
    return _field(d, "h", "D")


def dayofweek(d):
    # 1970-01-01, day 0, was a Thursday (3)
    return (_days(d).astype(np.int64) + 3) % 7


def day(d):
    return _field(d, "D", "M") + 1


def dayofyear(d):
    return _field(d, "D", "Y") + 1


def month(d):
    return d.astype("datetime64[M]").astype(np.int64) % 12 + 1


def isoweek(d):
    """ISO-8601 week number: 1 + whole weeks from January 1 to the
    Thursday of d's Monday-to-Sunday week, in that Thursday's year."""
    thursday = _days(d) - dayofweek(d).astype("timedelta64[D]") \
        + np.timedelta64(3, "D")
    return _field(thursday, "D", "Y") // 7 + 1


def second_of_minute(d):  # [-0.5, 0.5]
    return second(d) / 59.0 - 0.5


def minute_of_hour(d):
    return minute(d) / 59.0 - 0.5


def hour_of_day(d):
    return hour(d) / 23.0 - 0.5


def day_of_week(d):
    return dayofweek(d) / 6.0 - 0.5


def day_of_month(d):
    return (day(d) - 1) / 30.0 - 0.5


def day_of_year(d):
    return (dayofyear(d) - 1) / 365.0 - 0.5


def month_of_year(d):
    return (month(d) - 1) / 11.0 - 0.5


def week_of_year(d):
    return (isoweek(d) - 1) / 52.0 - 0.5


_FREQ_FEATURES = {
    "a": [], "m": [month_of_year], "w": [day_of_month, week_of_year],
    "d": [day_of_week, day_of_month, day_of_year],
    "b": [day_of_week, day_of_month, day_of_year],
    "h": [hour_of_day, day_of_week, day_of_month, day_of_year],
    "t": [minute_of_hour, hour_of_day, day_of_week, day_of_month, day_of_year],
    "s": [second_of_minute, minute_of_hour, hour_of_day, day_of_week,
          day_of_month, day_of_year],
}


def time_features(dates: np.ndarray, freq: str = "h") -> np.ndarray:
    """dates: datetime64 array -> (num_features, len(dates)) float32."""
    dates = np.asarray(dates, dtype="datetime64[s]")
    feats = _FREQ_FEATURES[freq.lower()[-1]]
    return np.vstack([np.asarray(f(dates), np.float32) for f in feats]) \
        if feats else np.zeros((0, len(dates)), np.float32)

"""The UEA path's host-side tools of the port against the JAX package's, on
the CPU.

- The native .ts scanner (sie_tpu_torch/native/ts_scan.cpp through
  data/native.py) against the JAX package's native scanner and the Python
  parsers of both packages, on UEA and Monash archives and missing
  values: the same labels and class labels, values equal to the JAX
  scanner's bit for bit (the same C++ code) and to the Python parser's
  within 1e-6 relative (tests/test_native_parser.py's limit: the scanner
  rounds its own decimal parse to f32). Its library is built under
  sie_tpu_torch/build/, never under sie_tpu/native/, and
  `parse_ts_file` takes it unless SIE_TPU_NO_NATIVE is set.
- `data/uea_alt.py` against sie_tpu/data/uea_alt.py: the cases of
  tests/test_uea_alt.py, each output equal to the JAX module's.
- `utils/print_args.py`: the same text as the JAX function for the same
  config (capsys).
- `smooth_array` equal to the JAX one; `visualize_shapelets` and
  `plot_tsne` write their files under matplotlib's Agg backend.
"""

import os

import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.data import native as jnative
from sie_tpu.data import uea_alt as juea_alt
from sie_tpu.data.synthetic import write_synthetic_monash as jmonash
from sie_tpu.data.synthetic import write_synthetic_uea as juea
from sie_tpu.data.ts_parser import _parse_ts_file_py as jparse_py
from sie_tpu.utils import print_args as jprint_args
from sie_tpu.utils import shapelet_util as jutil
from sie_tpu_torch.config import Config
from sie_tpu_torch.data import native, ts_parser
from sie_tpu_torch.data import uea_alt
from sie_tpu_torch.utils import print_args, shapelet_util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_ts(a, b, exact: bool):
    assert (a.n_samples, a.n_dims, a.labels, a.class_labels,
            a.is_regression, a.problem_name, a.equal_length) == \
        (b.n_samples, b.n_dims, b.labels, b.class_labels, b.is_regression,
         b.problem_name, b.equal_length)
    for sa, sb in zip(a.series, b.series):
        assert len(sa) == len(sb)
        for da, db in zip(sa, sb):
            assert da.dtype == db.dtype == np.float32
            if exact:
                np.testing.assert_array_equal(da, db)
            else:
                np.testing.assert_allclose(da, db, rtol=1e-6)


def _uea(tmp_path):
    juea(str(tmp_path), "Toy", n_train=12, n_test=4, n_dims=3, length=25,
         n_classes=3, seed=5)
    return str(tmp_path / "Toy" / "Toy_TRAIN.ts")


def _monash(tmp_path):
    jmonash(str(tmp_path), "ToyReg", n_train=8, n_test=4, n_dims=2,
            length=30, seed=6)
    return str(tmp_path / "ToyReg" / "ToyReg_TRAIN.ts")


def _missing(tmp_path):
    p = tmp_path / "m.ts"
    p.write_text("@problemName m\n@classLabel true a b\n@data\n"
                 "1.0,?,3.0:4.0,5.0,6.0:a\n"
                 "7.0,8.0,9.0:10.0,?,12.0:b\n")
    return str(p)


ARCHIVES = {"uea": _uea, "monash": _monash, "missing": _missing}


@pytest.mark.parametrize("kind", sorted(ARCHIVES))
def test_native_scanner_matches_both_packages(kind, tmp_path):
    path = ARCHIVES[kind](tmp_path)
    assert native.native_available() and jnative.native_available()
    before = native.files_parsed
    got = native.parse_ts_file_fast(path)
    assert native.files_parsed == before + 1
    _same_ts(got, jnative.parse_ts_file_fast(path), exact=True)
    _same_ts(got, jparse_py(path), exact=False)
    _same_ts(got, ts_parser._parse_ts_file_py(path), exact=False)
    if kind == "missing":
        assert np.isnan(got.series[0][0][1]) and got.labels == ["a", "b"]
    if kind == "monash":
        assert got.is_regression


def test_parse_ts_file_takes_the_native_scanner(tmp_path, monkeypatch):
    path = _uea(tmp_path)
    lib = native.library_path()
    assert os.path.dirname(lib) == os.path.join(ROOT, "sie_tpu_torch",
                                                 "build")
    assert native.native_available() and os.path.exists(lib)
    assert os.path.basename(lib) not in os.listdir(
        os.path.join(ROOT, "sie_tpu", "native"))
    monkeypatch.delenv("SIE_TPU_NO_NATIVE", raising=False)
    before = native.files_parsed
    fast = ts_parser.parse_ts_file(path)
    assert native.files_parsed == before + 1
    monkeypatch.setenv("SIE_TPU_NO_NATIVE", "1")
    slow = ts_parser.parse_ts_file(path)
    assert native.files_parsed == before + 1
    _same_ts(fast, slow, exact=False)
    _same_ts(ts_parser.parse_ts_file(path, use_native=True),
             ts_parser._parse_ts_file_py(path), exact=True)


def _write_ragged_ts(path, rows, labels, classes):
    lines = ["@problemName rag", "@timeStamps false", "@univariate false",
             f"@classLabel true {' '.join(classes)}", "@data"]
    for chans, lab in zip(rows, labels):
        cell = ":".join(",".join(f"{v:.6f}" for v in ch) for ch in chans)
        lines.append(f"{cell}:{lab}")
    path.write_text("\n".join(lines) + "\n")


def test_interp_to_length_equal():
    s = np.array([0.0, 1.0, 4.0, 9.0], np.float32)
    for series, length in ((s, 7), (s, 4), (s[:1], 3), (s, 2)):
        got = uea_alt._interp_to_length(series, length)
        want = juea_alt._interp_to_length(series, length)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm", ["standard", "minmax", "zscore"])
def test_normalizer_equal(norm):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (4, 2, 50))
    got, want = uea_alt.Normalizer(norm), juea_alt.Normalizer(norm)
    if norm == "zscore":
        for n in (got, want):
            with pytest.raises(NameError):
                n.normalize(x)
        return
    for arr in (x, x + 10.0):     # the first call's statistics are reused
        np.testing.assert_array_equal(got.normalize(arr), want.normalize(arr))


def test_label_encoder_equal():
    got, want = uea_alt.LabelEncoderLite(), juea_alt.LabelEncoderLite()
    y = ["dog", "ant", "cat", "ant"]
    np.testing.assert_array_equal(got.fit_transform(y), want.fit_transform(y))
    np.testing.assert_array_equal(got.classes_, want.classes_)
    np.testing.assert_array_equal(got.transform(["cat", "dog"]),
                                  want.transform(["cat", "dog"]))
    for enc in (got, want):
        with pytest.raises(ValueError):
            enc.transform(["bee"])
    with pytest.raises(ValueError):
        uea_alt.LabelEncoderLite().transform(["a"])


def _datasets_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert (a.num_class, len(a), a.fit) == (b.num_class, len(b), b.fit)
    for i in range(len(a)):
        for u, v in zip(a[i], b[i]):
            np.testing.assert_array_equal(u, v)


def test_uea_dataset_equal_length(tmp_path):
    juea(str(tmp_path), "Toy", n_train=10, n_test=6, n_dims=3, length=20,
         n_classes=3, seed=1)
    kw = dict(root_dir=str(tmp_path))
    ptr = uea_alt.UEADataset("Toy", flag="TRAIN", **kw)
    jtr = juea_alt.UEADataset("Toy", flag="TRAIN", **kw)
    _datasets_equal(ptr, jtr)
    pte = uea_alt.UEADataset("Toy", flag="TEST",
                             label_encoder=ptr.label_encoder, **kw)
    jte = juea_alt.UEADataset("Toy", flag="TEST",
                              label_encoder=jtr.label_encoder, **kw)
    _datasets_equal(pte, jte)
    assert ptr.x.shape == (10, 3, 20) and ptr[4][1].shape == (1,)


def test_uea_dataset_ragged_equal(tmp_path):
    d = tmp_path / "Rag"
    d.mkdir()
    rows = [[np.linspace(0, 1, 5), np.linspace(1, 0, 5)],
            [np.linspace(0, 2, 9), np.linspace(2, 0, 9)],
            [np.linspace(0, 3, 7), np.linspace(3, 0, 7)]]
    _write_ragged_ts(d / "Rag_TRAIN.ts", rows, ["a", "b", "a"], ["a", "b"])
    got = uea_alt.UEADataset("Rag", root_dir=str(tmp_path), flag="TRAIN")
    _datasets_equal(got, juea_alt.UEADataset("Rag", root_dir=str(tmp_path),
                                             flag="TRAIN"))
    assert got.x.shape == (3, 2, 9)


@pytest.mark.parametrize("kw", [{}, dict(
    model="InterpGN", dnn_type="FCN", num_shapelet=10, seed=42, lr=5e-3,
    dataset="SelfRegulationSCP2", augment=("noise",))])
def test_print_args_prints_the_jax_text(kw, capsys):
    print_args.print_args(Config(**kw))
    got = capsys.readouterr().out
    jprint_args.print_args(JConfig(**kw))
    assert got == capsys.readouterr().out
    assert got.count("\n") == len(Config.__dataclass_fields__) + 4
    ns = type("Args", (), {})()
    ns.__dict__.update(a=1, b="x", c=(1, 2))
    print_args.print_args(ns)
    got = capsys.readouterr().out
    jprint_args.print_args(ns)
    assert got == capsys.readouterr().out and "  c: (1, 2)" in got


def test_smooth_array_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=31)
    for window in (1, 3, 5, 8):
        np.testing.assert_array_equal(shapelet_util.smooth_array(x, window),
                                      jutil.smooth_array(x, window))
    assert shapelet_util.smooth_array(x, 1) is x


def _result():
    rng = np.random.default_rng(0)
    return shapelet_util.ClassificationResult(
        accuracy=0.8, loss=0.5, num_samples=4,
        x=rng.normal(size=(4, 50, 2)).astype(np.float32),
        preds=rng.normal(size=(4, 3)).astype(np.float32),
        trues=np.array([0, 1, 2, 0]),
        w=np.abs(rng.normal(size=(3, 6))).astype(np.float32),
        shapelets=[(rng.normal(size=7).astype(np.float32), i % 2)
                   for i in range(6)])


def test_plots_write_their_files(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    out = shapelet_util.visualize_shapelets(
        _result(), sample_idx=0, top_k=3, save_path=str(tmp_path / "v.png"))
    assert out == str(tmp_path / "v.png") and os.path.getsize(out) > 0
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(24, 5)).astype(np.float32)
    out = shapelet_util.plot_tsne(feats, np.arange(24) % 3,
                                  save_path=str(tmp_path / "t.png"))
    assert out == str(tmp_path / "t.png") and os.path.getsize(out) > 0
    import matplotlib
    assert matplotlib.get_backend().lower() == "agg"

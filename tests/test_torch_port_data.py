"""The port's data path against the JAX package's, on the CPU.

The numpy-only modules are copies, so their outputs must be equal
(`np.array_equal`): the batch order, the synthetic generators, the UEA
writer and loader (both on the Python .ts parser), the FIFF writer and
reader. The preprocessing is ported from a jitted XLA program to torch:
`process_trials` at 8 channels, both cropping and Fourier resampling,
keeps the same trials and labels, with outputs within 1e-5 abs (f32 FFTs
and sums in another order, on z-scored values of order 1)."""

import os

import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.data import eeg as jeeg
from sie_tpu.data import fif as jfif
from sie_tpu.data import loader as jloader
from sie_tpu.data import synthetic as jsynth
from sie_tpu.data import uea as juea
from sie_tpu_torch.config import Config
from sie_tpu_torch.data import eeg as peeg
from sie_tpu_torch.data import fif as pfif
from sie_tpu_torch.data import loader as ploader
from sie_tpu_torch.data import synthetic as psynth
from sie_tpu_torch.data import uea as puea
from sie_tpu_torch.data.provider import data_provider


@pytest.mark.parametrize("seed,epoch,shuffle", [(0, 0, True), (0, 3, True),
                                                (7, 1, True), (42, 0, False)])
def test_batcher_schedules_equal(seed, epoch, shuffle):
    rng = np.random.default_rng(1)
    n, t, c = 23, 5, 2
    arrays = dict(x=rng.normal(size=(n, t, c)).astype(np.float32),
                  y=rng.integers(0, 3, n).astype(np.int32),
                  padding_mask=np.ones((n, t), np.float32))
    jb = jloader.Batcher(jloader.ArrayDataset(**arrays), 8, shuffle, seed)
    pb = ploader.Batcher(ploader.ArrayDataset(**arrays), 8, shuffle, seed)
    assert len(jb) == len(pb) == 3
    for (ji, jw), (pi, pw) in zip(jb.epoch_indices(epoch),
                                  pb.epoch_indices(epoch)):
        assert np.array_equal(ji, pi) and np.array_equal(jw, pw)
        assert ji.dtype == pi.dtype and pi.shape == (8,)
    for jbatch, pbatch in zip(jb.epoch(epoch), pb.epoch(epoch)):
        for a, b in zip(jbatch, pbatch):
            assert np.array_equal(a, b)


def test_synthetic_eeg_trials_equal():
    for kw in (dict(n_trials=12, n_channels=4, n_times=60),
               dict(n_trials=9, n_channels=3, n_times=40, n_subjects=2,
                    seed=5, imbalanced=True)):
        (jr, jl, js), (pr, pl, ps) = (jsynth.synthetic_eeg_trials(**kw),
                                      psynth.synthetic_eeg_trials(**kw))
        assert np.array_equal(jr, pr) and jl == pl and np.array_equal(js, ps)
    assert jsynth.synthetic_textmaps() == psynth.synthetic_textmaps()


def test_synthetic_uea_written_and_loaded_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("SIE_TPU_NO_NATIVE", "1")   # the Python parser
    kw = dict(dataset="Toy", n_train=10, n_test=6, n_dims=3, length=20,
              n_classes=3, seed=4)
    jroot = jsynth.write_synthetic_uea(str(tmp_path / "j"), **kw)
    proot = psynth.write_synthetic_uea(str(tmp_path / "p"), **kw)
    for split in ("TRAIN", "TEST"):
        name = f"Toy_{split}.ts"
        with open(os.path.join(jroot, name), "rb") as a, \
                open(os.path.join(proot, name), "rb") as b:
            assert a.read() == b.read()
    for flag in ("train", "test"):
        for norm in ("standardization", "per_sample_minmax"):
            j = juea.load_uea_dataset(str(tmp_path / "j"), "Toy", flag, norm)
            p = puea.load_uea_dataset(str(tmp_path / "p"), "Toy", flag, norm)
            for f in ("x", "y", "padding_mask"):
                assert np.array_equal(getattr(j, f), getattr(p, f)), f
            assert (j.num_class, j.class_names, j.max_seq_len) == \
                (p.num_class, p.class_names, p.max_seq_len)


def test_fif_written_and_read_equal(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(3, 4, 25)) * 1e-5
    names = [f"EEG{i}" for i in range(4)]
    md = [{"Word": w} for w in ("a", "b", None)]
    kinds = [jfif.FIFFV_EEG_CH] * 3 + [202]
    jfif.write_epochs_fif(str(tmp_path / "j.fif"), data, names, 500.0, md,
                          kinds)
    pfif.write_epochs_fif(str(tmp_path / "p.fif"), data, names, 500.0, md,
                          kinds)
    assert (tmp_path / "j.fif").read_bytes() == (tmp_path / "p.fif").read_bytes()
    pfif.write_epochs_fif(str(tmp_path / "p.fif.gz"), data, names, 500.0, md,
                          kinds)
    for path in ("j.fif", "p.fif.gz"):
        j = jfif.read_epochs_fif(str(tmp_path / path))
        p = pfif.read_epochs_fif(str(tmp_path / path))
        assert np.array_equal(j.get_data(), p.get_data())
        assert np.array_equal(j.pick_eeg(), p.pick_eeg())
        assert (j.ch_names, j.ch_kinds, j.sfreq, j.metadata) == \
            (p.ch_names, p.ch_kinds, p.sfreq, p.metadata)


@pytest.mark.parametrize("n_times,target", [(400, 400), (150, 400)],
                         ids=["crop", "resample"])
def test_process_trials_matches(n_times, target):
    raw, labels, subjects = jsynth.synthetic_eeg_trials(
        n_trials=12, n_channels=6, n_times=n_times, seed=2)
    raw[3] *= 1e4                  # fails the QA bounds in both
    labels[5] = "not_a_word"       # dropped by the label map in both
    maps = jsynth.synthetic_textmaps()
    kw = dict(target_channels=8, target_timepoints=target)
    jx, jy, js = jeeg.process_trials(raw, labels, subjects, maps, True,
                                     JConfig(**kw), batch=5)
    px, py, ps = peeg.process_trials(raw, labels, subjects, maps, True,
                                     Config(**kw), batch=5)
    assert np.array_equal(jy, py) and np.array_equal(js, ps)
    assert len(py) == 10 and px.shape == (10, 8, int(target * 256 / 500))
    assert np.abs(jx - px).max() <= 1e-5


def test_eeg_splits_through_the_provider(tmp_path):
    """The synthetic fallback, the npz cache and the split of the
    provider: the same rows and labels as the JAX package."""
    kw = dict(data="EEG3", data_root=str(tmp_path / "none"), max_files=3,
              target_channels=5, target_timepoints=120, batch_size=4, seed=0,
              cache_dir=str(tmp_path / "cache"))
    from sie_tpu.data.provider import data_provider as jprovider
    for flag in ("train", "val", "test"):
        jds, jb = jprovider(JConfig(**kw), flag)
        pds, pb = data_provider(Config(**kw), flag)
        assert np.array_equal(jds.y, pds.y)
        assert np.abs(jds.x - pds.x).max() <= 1e-5
        assert [np.array_equal(a[0], b[0]) for a, b in
                zip(jb.epoch_indices(1), pb.epoch_indices(1))] == \
            [True] * len(jb)


def test_eeg_from_fif_files_equal(tmp_path):
    """The real-data path: two subjects' imagine-task .fif files with word
    labels in the metadata, read, mapped, processed and split."""
    import json
    raw, labels, _ = jsynth.synthetic_eeg_trials(n_trials=16, n_channels=5,
                                                 n_times=300, seed=6)
    names = [f"EEG{i}" for i in range(5)]
    for s, sub in enumerate(("sub-01", "sub-02")):
        os.makedirs(tmp_path / sub)
        rows = slice(8 * s, 8 * s + 8)
        pfif.write_epochs_fif(str(tmp_path / sub / "run_imagine.fif"),
                              raw[rows], names, 500.0,
                              [{"Word": w} for w in labels[rows]])
    with open(tmp_path / "maps.json", "w") as f:
        json.dump(psynth.synthetic_textmaps(), f)
    kw = dict(data="EEG", data_root=str(tmp_path),
              json_path=str(tmp_path / "maps.json"),
              subject_ids=("sub-01", "sub-02"), target_channels=6,
              target_timepoints=400, cache_dir=str(tmp_path / "cache"))
    for flag in ("train", "test"):
        j = jeeg.load_eeg_dataset(JConfig(**kw), flag, three_class=False)
        p = peeg.load_eeg_dataset(Config(**kw), flag, three_class=False)
        assert np.array_equal(j.y, p.y) and \
            np.array_equal(j.subject_ids, p.subject_ids)
        assert p.x.shape[1:] == (204, 6) and np.abs(j.x - p.x).max() <= 1e-5


@pytest.mark.parametrize("data", ["custom", "ETTh1", "m4", "PSM"])
def test_formerly_unported_data_families_load(data, tmp_path):
    """The families whose loaders raised until the tasks were ported: each
    now loads the same windows as the JAX package's provider."""
    from sie_tpu.data.provider import data_provider as jax_provider
    rng = np.random.default_rng(2)
    root = str(tmp_path)
    if data in ("custom", "ETTh1"):
        psynth.write_synthetic_ett(os.path.join(root, f"{data}.csv"),
                                   n_rows=500)
    elif data == "m4":
        psynth.write_synthetic_m4(root, "Monthly", n_series=12, min_len=30,
                                  max_len=50)
    else:
        np.save(tmp_path / "PSM_train.npy", rng.normal(size=(400, 5)))
        np.save(tmp_path / "PSM_test.npy", rng.normal(size=(300, 5)))
        np.save(tmp_path / "PSM_test_label.npy", np.zeros(300, np.float32))
    kw = dict(data=data, dataset=data, data_root=root, seq_len=24,
              label_len=8, pred_len=8, batch_size=4)
    jds, jb = jax_provider(JConfig(**kw), "train")
    pds, pb = data_provider(Config(**kw), "train")
    assert len(pds) == len(jds) > 0 and len(pb) == len(jb)
    for a, b in zip(next(iter(jb)), next(iter(pb))):
        assert np.array_equal(a, b)

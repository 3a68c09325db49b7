"""`--stream_from_disk` in the port (sie_tpu_torch/data/stream.py, the
provider's cache-first branch, the experiment's host feed) against the
JAX package's, on the CPU.

A memmap cache written by either package opens in the other with equal
arrays; `_stream_path` names the same directory for the same config;
`lazy_select` composes index maps and reads the rows the JAX one reads;
the prefetcher keeps its order and relays a producer's error; a warm
cache opens without the registry loader; and a streamed run through the
command line (SBM, f32) trains on the same rows in the same order as the
in-memory run: the same per-epoch losses, bit for bit, and the same test
accuracy."""

import json
import os

import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.data import loader as jloader
from sie_tpu.data import provider as jprovider
from sie_tpu.data import stream as jstream
from sie_tpu_torch import run as port_run
from sie_tpu_torch.config import Config
from sie_tpu_torch.data import loader as ploader
from sie_tpu_torch.data import provider as pprovider
from sie_tpu_torch.data import stream as pstream
from sie_tpu_torch.data.synthetic import write_synthetic_uea

FIELDS = ("x", "y", "padding_mask", "subject_ids")


def _arrays(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(n, 11, 3)).astype(np.float32),
                y=rng.integers(0, 4, n).astype(np.int32),
                padding_mask=(rng.uniform(size=(n, 11)) > 0.2
                              ).astype(np.float32),
                subject_ids=rng.integers(0, 3, n).astype(np.int32),
                bin_edges=np.linspace(0, 1, 5).astype(np.float32),
                num_class=4, class_names=("a", "b", "c", "d"),
                original_fs=500, target_fs=256)


def _same(a, b):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    for f in ("max_seq_len", "enc_in", "num_class", "class_names",
              "original_fs", "target_fs"):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.bin_edges, b.bin_edges)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_crosses_between_the_packages(tmp_path, writer):
    arrays = _arrays()
    path = str(tmp_path / "stream_x")
    if writer == "jax":
        jstream.save_memmap_dataset(path, jloader.ArrayDataset(**arrays),
                                    chunk_rows=8)
        got = pstream.open_memmap_dataset(path)
        want = jstream.open_memmap_dataset(path)
    else:
        pstream.save_memmap_dataset(path, ploader.ArrayDataset(**arrays),
                                    chunk_rows=8)
        got = jstream.open_memmap_dataset(path)
        want = pstream.open_memmap_dataset(path)
    _same(got, want)
    _same(got, ploader.ArrayDataset(**arrays))
    assert isinstance(want.x, np.memmap) and isinstance(got.x, np.memmap)
    assert sorted(os.listdir(path)) == ["meta.json", "padding_mask.npy",
                                        "subject_ids.npy", "x.npy", "y.npy"]


@pytest.mark.parametrize("flag,loso,change", [
    ("train", None, {}), ("val", None, {"seed": 3}),
    ("test", 2, {"data": "EEG", "subject_ids": ("sub-01", "sub-04")}),
    ("train", None, {"data": "UEA", "dataset": "Toy", "normalizer": "minmax",
                     "cache_dir": "/elsewhere"})])
def test_stream_path_is_the_jax_one(flag, loso, change):
    kw = dict(dict(data="EEG3", max_files=7, target_channels=9), **change)
    assert pprovider._stream_path(Config(**kw), flag, loso) == \
        jprovider._stream_path(JConfig(**kw), flag, loso)


def test_lazy_select_composes_like_jax(tmp_path):
    path = str(tmp_path / "s")
    pstream.save_memmap_dataset(path, ploader.ArrayDataset(**_arrays(50)))
    a = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 35, 49, 0])
    b = np.array([7, 2, 2, 0, 11])
    j = jstream.open_memmap_dataset(path).select(a).select(b)
    p = pstream.open_memmap_dataset(path).select(a).select(b)
    assert isinstance(p.x, pstream._IndexedField)
    assert np.array_equal(p.x._map, a[b])       # one composed map
    _same(p, j)
    assert p.x.nbytes == j.x.nbytes and len(p) == len(j) == 5
    idx = np.array([4, 0, 2])
    assert np.array_equal(p.x[idx], j.x[idx])
    # an in-memory dataset selects eagerly
    eager = ploader.ArrayDataset(**_arrays(50)).select(a)
    assert type(eager.x) is np.ndarray and eager.x.shape == (12, 11, 3)
    assert np.array_equal(eager.x, np.asarray(
        pstream.open_memmap_dataset(path).select(a).x))


def test_prefetch_keeps_order_and_relays_errors():
    batches = [(np.full((2,), i),) for i in range(9)]
    got = list(pstream.prefetch_to_device(iter(batches), depth=3,
                                          device_put=lambda b: b))
    assert [int(b[0][0]) for b in got] == list(range(9))

    def broken():
        yield (np.zeros(1),)
        raise RuntimeError("disk gone")

    it = pstream.prefetch_to_device(broken(), device_put=lambda b: b)
    assert next(it)[0].shape == (1,)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(it)


def test_warm_cache_opens_without_the_loader(tmp_path, monkeypatch):
    write_synthetic_uea(str(tmp_path), "Toy", n_train=20, n_test=10,
                        n_dims=2, length=16, n_classes=2, seed=1)
    calls = []
    real = pprovider.DATA_REGISTRY["UEA"]
    monkeypatch.setitem(pprovider.DATA_REGISTRY, "UEA",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = Config(data="UEA", dataset="Toy", data_root=str(tmp_path),
                 cache_dir=str(tmp_path / "cache"), stream_from_disk=True,
                 batch_size=4)
    cold, _ = pprovider.data_provider(cfg, "train")
    warm, batcher = pprovider.data_provider(cfg, "train")
    assert len(calls) == 1
    assert isinstance(warm.x, np.memmap) and type(batcher).__name__ == \
        "Batcher"
    _same(cold, warm)
    # the JAX package opens the port's cache without its loader too
    jds, _ = jprovider.data_provider(JConfig(**{
        f: getattr(cfg, f) for f in ("data", "dataset", "data_root",
                                     "cache_dir", "stream_from_disk",
                                     "batch_size")}), "train")
    _same(jds, warm)


def _cli(root, ck, *extra):
    return ["--device", "cpu", "--data", "UEA", "--data_root", root,
            "--dataset", "Toy", "--model", "SBM", "--num_shapelet", "2",
            "--no-amp", "--batch_size", "8", "--train_epochs", "2",
            "--patience", "5", "--log_interval", "1", "--seed", "0",
            "--checkpoint_dir", os.path.join(root, ck),
            "--result_dir", os.path.join(root, "result"),
            "--cache_dir", os.path.join(root, "cache"),
            "--metrics_jsonl", os.path.join(root, f"{ck}.jsonl"), *extra]


def test_streamed_cli_run_equals_the_in_memory_run(tmp_path):
    root = str(tmp_path)
    write_synthetic_uea(root, "Toy", n_train=28, n_test=12, n_dims=3,
                        length=30, n_classes=2, seed=9)
    ram = port_run.main(_cli(root, "ram"))
    streamed = port_run.main(_cli(root, "stream", "--stream_from_disk"))
    losses = lambda ck: [json.loads(l)["train_loss"] for l in
                         open(os.path.join(root, f"{ck}.jsonl"))]
    assert losses("stream") == losses("ram") and len(losses("ram")) == 2
    assert streamed[0][2]["accuracy"] == ram[0][2]["accuracy"]
    caches = sorted(d.split("_")[2] for d in
                    os.listdir(os.path.join(root, "cache"))
                    if d.startswith("stream_UEA_"))
    assert caches == ["test", "train", "val"]

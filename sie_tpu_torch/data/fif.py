"""Self-contained FIFF (.fif/.fif.gz) epochs reader and writer, with no MNE
dependency: a copy of sie_tpu/data/fif.py (numpy and the standard library
only), so the port reads CHISCO epochs files without the JAX package.

- `read_epochs_fif` scans the flat big-endian (kind, type, size, next) tag
  stream rather than walking the block tree. It collects the measurement
  info (FIFF_NCHAN=200, FIFF_SFREQ=201, FIFF_CH_INFO=203 96-byte structs),
  the epochs metadata JSON (FIFF_DESCRIPTION=206, where MNE writes
  `epochs.metadata` as records) and the epochs tensor (FIFF_EPOCH=302, a
  dense FIFFT_MATRIX|FLOAT with the trailing-dims footer), and applies the
  per-channel cal*range scaling as MNE's read path does.
- `write_epochs_fif` writes a minimal valid FIFF file (file-id tag, dir
  pointer, MEAS > MEAS_INFO > EPOCHS blocks); `.gz` names go through gzip.
"""

from __future__ import annotations

import gzip
import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---- FIFF constants (public spec) ----------------------------------------
FIFF_FILE_ID = 100
FIFF_DIR_POINTER = 101
FIFF_BLOCK_START = 104
FIFF_BLOCK_END = 105
FIFF_NCHAN = 200
FIFF_SFREQ = 201
FIFF_CH_INFO = 203
FIFF_DESCRIPTION = 206
FIFF_EPOCH = 302

FIFFT_INT = 3
FIFFT_FLOAT = 4
FIFFT_STRING = 10
FIFFT_CH_INFO_STRUCT = 30
FIFFT_ID_STRUCT = 31
FIFFT_MATRIX = 0x40000000

FIFFB_MEAS = 100
FIFFB_MEAS_INFO = 101
FIFFB_EPOCHS = 373

FIFFV_EEG_CH = 2
FIFF_UNIT_V = 107

_TAG = struct.Struct(">iiii")
_CH_INFO = struct.Struct(">iiiffi12fii16s")   # fiffChInfoRec, 96 bytes


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# ---- writer ----------------------------------------------------------------

class _Writer:
    def __init__(self, fh):
        self.fh = fh

    def tag(self, kind: int, dtype: int, data: bytes):
        self.fh.write(_TAG.pack(kind, dtype, len(data), 0))
        self.fh.write(data)

    def tag_int(self, kind: int, value: int):
        self.tag(kind, FIFFT_INT, struct.pack(">i", value))

    def tag_float(self, kind: int, value: float):
        self.tag(kind, FIFFT_FLOAT, struct.pack(">f", value))

    def tag_string(self, kind: int, value: str):
        self.tag(kind, FIFFT_STRING, value.encode("utf-8"))

    def block_start(self, kind: int):
        self.tag(FIFF_BLOCK_START, FIFFT_INT, struct.pack(">i", kind))

    def block_end(self, kind: int):
        self.tag(FIFF_BLOCK_END, FIFFT_INT, struct.pack(">i", kind))

    def float_matrix(self, kind: int, arr: np.ndarray):
        """Dense FIFFT_MATRIX|FLOAT: row-major values then the dims footer —
        dims fastest-varying first, then the number of dims, all int32."""
        arr = np.ascontiguousarray(arr, dtype=">f4")
        dims = list(arr.shape)
        footer = list(reversed(dims)) + [arr.ndim]
        data = arr.tobytes() + np.asarray(footer, ">i4").tobytes()
        self.tag(kind, FIFFT_MATRIX | FIFFT_FLOAT, data)


def write_epochs_fif(path: str, data: np.ndarray, ch_names: Sequence[str],
                     sfreq: float, metadata: Optional[List[Dict]] = None,
                     ch_kinds: Optional[Sequence[int]] = None):
    """data: (n_epochs, n_channels, n_times) volts; metadata: per-epoch dicts
    (e.g. [{"Word": "..."}]) serialized as the records-orient JSON MNE uses.
    Channels are written with cal=range=1 (data stored fully calibrated)."""
    data = np.asarray(data)
    n_ep, n_ch, _n_t = data.shape
    assert len(ch_names) == n_ch
    kinds = list(ch_kinds) if ch_kinds is not None else [FIFFV_EEG_CH] * n_ch
    with _open(path, "wb") as fh:
        w = _Writer(fh)
        # file id: version, machid[2], time(sec, usec)
        w.tag(FIFF_FILE_ID, FIFFT_ID_STRUCT,
              struct.pack(">5i", (1 << 16) | 3, 0, 0, 0, 0))
        w.tag_int(FIFF_DIR_POINTER, -1)
        w.block_start(FIFFB_MEAS)
        w.block_start(FIFFB_MEAS_INFO)
        w.tag_int(FIFF_NCHAN, n_ch)
        w.tag_float(FIFF_SFREQ, float(sfreq))
        for i, name in enumerate(ch_names):
            w.tag(FIFF_CH_INFO, FIFFT_CH_INFO_STRUCT, _CH_INFO.pack(
                i + 1, i + 1, kinds[i], 1.0, 1.0, 1,
                *([0.0] * 12), FIFF_UNIT_V, 0,
                name.encode("utf-8")[:15].ljust(16, b"\x00")))
        w.block_end(FIFFB_MEAS_INFO)
        w.block_start(FIFFB_EPOCHS)
        if metadata is not None:
            w.tag_string(FIFF_DESCRIPTION, json.dumps(list(metadata)))
        w.float_matrix(FIFF_EPOCH, data)
        w.block_end(FIFFB_EPOCHS)
        w.block_end(FIFFB_MEAS)


# ---- reader ----------------------------------------------------------------

def _iter_tags(buf: bytes):
    pos, n = 0, len(buf)
    while pos + 16 <= n:
        tag_start = pos
        kind, dtype, size, next_ = _TAG.unpack_from(buf, pos)
        pos += 16
        if size < 0 or pos + size > n:
            break
        yield kind, dtype, buf[pos:pos + size]
        pos += size
        if next_ > 0:            # explicit jump (rare; sequential files use 0)
            if next_ <= tag_start:   # corrupt backwards pointer: would loop
                raise ValueError(
                    f"corrupt FIFF tag chain: next={next_} does not advance "
                    f"past tag at {tag_start}")
            pos = next_
        elif next_ == -1:        # end of tag list
            break


def _decode_matrix(data: bytes, elem: str):
    ndims = struct.unpack(">i", data[-4:])[0]
    if not 1 <= ndims <= 4:
        raise ValueError(f"bad FIFF matrix footer ndims={ndims}")
    footer = np.frombuffer(data[-4 * (ndims + 1):-4], ">i4")
    shape = tuple(int(d) for d in footer[::-1])
    count = int(np.prod(shape))
    vals = np.frombuffer(data, ">" + elem, count=count)
    return vals.reshape(shape)


class EpochsFile:
    """Parsed epochs container mirroring the mne.Epochs surface the reference
    uses: .get_data(), .metadata (list of per-epoch dicts or None),
    .ch_names, .ch_kinds, .sfreq, len()."""

    def __init__(self, data, ch_names, ch_kinds, sfreq, metadata):
        self._data = data
        self.ch_names = ch_names
        self.ch_kinds = ch_kinds
        self.sfreq = sfreq
        self.metadata = metadata

    def __len__(self):
        return self._data.shape[0]

    def get_data(self) -> np.ndarray:
        return self._data

    def pick_eeg(self) -> np.ndarray:
        """Indices of EEG channels (mne.pick_types(eeg=True) equivalent)."""
        return np.asarray([i for i, k in enumerate(self.ch_kinds)
                           if k == FIFFV_EEG_CH], np.int64)


def read_epochs_fif(path: str) -> EpochsFile:
    with _open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) < 16:
        raise ValueError(f"not a FIFF file (too short): {path}")
    kind0, dtype0, _, _ = _TAG.unpack(buf[:16])
    if kind0 != FIFF_FILE_ID or dtype0 != FIFFT_ID_STRUCT:
        raise ValueError(f"not a FIFF file (no file-id tag): {path}")

    nchan = None
    sfreq = None
    chs: List[Tuple[str, int, float]] = []      # (name, kind, cal*range)
    metadata = None
    epochs = None
    for kind, dtype, data in _iter_tags(buf):
        if kind == FIFF_NCHAN and dtype == FIFFT_INT:
            nchan = struct.unpack(">i", data[:4])[0]
        elif kind == FIFF_SFREQ and dtype == FIFFT_FLOAT:
            sfreq = struct.unpack(">f", data[:4])[0]
        elif kind == FIFF_CH_INFO and dtype == FIFFT_CH_INFO_STRUCT:
            f = _CH_INFO.unpack(data[:96])
            name = f[-1].split(b"\x00", 1)[0].decode("utf-8", "replace")
            chs.append((name, f[2], f[3] * f[4]))    # kind, range*cal
        elif kind == FIFF_DESCRIPTION and dtype == FIFFT_STRING:
            try:
                md = json.loads(data.decode("utf-8"))
            except ValueError:
                md = None
            if isinstance(md, list):
                metadata = md
            elif isinstance(md, dict):             # columns-orient fallback
                cols = list(md)
                n = max((len(v) for v in md.values()), default=0)
                metadata = [{c: md[c].get(str(i), md[c].get(i))
                             for c in cols} for i in range(n)]
        elif kind == FIFF_EPOCH and (dtype & FIFFT_MATRIX):
            elem = {FIFFT_FLOAT: "f4", 5: "f8"}.get(dtype & 0xFFFF)
            if elem is None:
                raise ValueError(f"unsupported FIFF_EPOCH dtype {dtype:#x}")
            epochs = _decode_matrix(data, elem).astype(np.float64)

    if epochs is None:
        raise ValueError(f"no epochs data (FIFF_EPOCH tag) in {path}")
    if epochs.ndim == 2:                          # single epoch written flat
        epochs = epochs[None]
    n_ch = epochs.shape[1]
    if nchan is not None and nchan != n_ch:
        raise ValueError(f"FIFF_NCHAN={nchan} contradicts the epochs tensor's "
                         f"{n_ch} channels in {path}")
    names = [c[0] for c in chs] or [f"ch{i}" for i in range(n_ch)]
    kinds = [c[1] for c in chs] or [FIFFV_EEG_CH] * n_ch
    cals = np.asarray([c[2] for c in chs] or [1.0] * n_ch, np.float64)
    if len(names) != n_ch:
        raise ValueError(f"ch_info count {len(names)} != data channels {n_ch}")
    epochs = epochs * cals[None, :, None]         # MNE read-side calibration
    return EpochsFile(epochs, names, kinds,
                      float(sfreq) if sfreq is not None else 0.0, metadata)

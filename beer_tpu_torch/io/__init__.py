"""Feature archives and batch loading (host side).

Counterpart of ``beer_tpu/io``: the flat binary archive format
("BEER_AR1", byte for byte the JAX package's, so either package reads
the other's archives), memory-mapped once and served as **padded
batches** filled by the native C++ reader (``native/archive.cpp``:
std::thread workers copying straight from the page cache), with a
pure-Python mmap reader when the toolchain is unavailable
(:attr:`Archive.native` says which one ran).  A double-buffered
:class:`BatchLoader` overlaps host-side batch assembly with device
compute.  Everything here is numpy and ctypes; batches reach the card
in the CLI.

The native reader is built by ``g++`` at first use into
``beer_tpu_torch/_build/`` (one library per source digest).

Format::

    magic   8s   = b"BEER_AR1"
    n_utts  u64
    index   per utt: id_len u32, id bytes, offset u64, n_frames u32, dim u32
    data    raw float32 frames (row-major), starting at each offset
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import struct as pystruct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_MAGIC = b"BEER_AR1"
_NATIVE_SRC = Path(__file__).resolve().parent / "native" / "archive.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


# ----------------------------------------------------------------------
# Writer (host-side, pure Python)
# ----------------------------------------------------------------------
def write_archive(path, utterances: Dict[str, np.ndarray]) -> None:
    """Write a BEER_AR1 archive from {uttid: (T, D) float32 array}.

    The archive is written to a writer-unique temp file and published
    with an atomic ``os.replace`` so concurrent readers (e.g. parallel
    jobs all converting the same .npz on first use) see either no file
    or a complete one, never a torn write.  The temp name comes from
    ``tempfile`` (O_EXCL-created random suffix), not the PID: converters
    on different hosts that share a filesystem can collide on PID.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    items = [(k, np.ascontiguousarray(v, np.float32)) for k, v in utterances.items()]
    index_size = 8 + 8
    for uttid, feats in items:
        index_size += 4 + len(uttid.encode()) + 8 + 4 + 4
    # Align the data section to 4 bytes so float32 frame pointers into the
    # mmap are aligned (each utterance's nbytes is a multiple of 4, so
    # alignment of the first offset carries through).
    data_start = -(-index_size // 4) * 4
    fd, tmp_name = tempfile.mkstemp(
        prefix=f".{path.name}.tmp.", dir=path.parent)
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(_MAGIC)
            fh.write(pystruct.pack("<Q", len(items)))
            offset = data_start
            for uttid, feats in items:
                encoded = uttid.encode()
                fh.write(pystruct.pack("<I", len(encoded)))
                fh.write(encoded)
                fh.write(pystruct.pack("<QII", offset, feats.shape[0], feats.shape[1]))
                offset += feats.nbytes
            fh.write(b"\0" * (data_start - index_size))
            for _, feats in items:
                fh.write(feats.tobytes())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def convert_npz(npz_path, archive_path) -> None:
    """Convert a numpy .npz feature archive to BEER_AR1."""
    data = np.load(npz_path)
    write_archive(archive_path, {k: data[k] for k in data.files})


def archive_geometry(path):
    """(n_utts, t_max, dim, total_frames) without loading feature data.

    ``.bar`` archives read only the index; ``.npz`` reads only each zip
    member's .npy header (shape/dtype), never the data — so deciding
    whether a corpus fits as one padded array costs O(n_utts) metadata
    reads, not a corpus load.
    """
    path = str(path)
    if path.endswith(".bar"):
        archive = Archive(path)
        lengths = np.asarray(archive.lengths)
        dim = archive.dim
        archive.close()
    else:
        import zipfile

        lengths = []
        dim = 0
        with zipfile.ZipFile(path) as zf:
            for name in zf.namelist():
                with zf.open(name) as fh:
                    # the public header readers (numpy 1 and 2 alike)
                    fmt = np.lib.format
                    read = (fmt.read_array_header_1_0 if fmt.read_magic(fh) == (1, 0)
                            else fmt.read_array_header_2_0)
                    shape, _, _ = read(fh)
                lengths.append(shape[0])
                dim = shape[-1] if len(shape) > 1 else 1
        lengths = np.asarray(lengths)
    if len(lengths) == 0:
        return 0, 0, dim, 0
    return len(lengths), int(lengths.max()), dim, int(lengths.sum())


# ----------------------------------------------------------------------
# Native library (compiled on demand, cached)
# ----------------------------------------------------------------------
_lib = None
_lib_failed = False


def _build_native() -> Path:
    """The reader's library for the current source, compiled by ``g++``
    unless it exists (written to a temporary name, then moved into place,
    so concurrent first uses never load a torn file)."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _NATIVE_SRC.read_bytes())
    so = _BUILD_DIR / f"libbeer_archive_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        subprocess.run(["g++", *_CXX_FLAGS, str(_NATIVE_SRC), "-o", f"{tmp}/lib.so"],
                       check=True, capture_output=True)
        os.replace(f"{tmp}/lib.so", so)
    return so


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build_native()))
    except Exception:
        _lib_failed = True
        return None
    lib.bar_open.restype = ctypes.c_void_p
    lib.bar_open.argtypes = [ctypes.c_char_p]
    lib.bar_close.argtypes = [ctypes.c_void_p]
    lib.bar_num_utts.restype = ctypes.c_int64
    lib.bar_num_utts.argtypes = [ctypes.c_void_p]
    lib.bar_utt_id.restype = ctypes.c_char_p
    lib.bar_utt_id.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bar_utt_frames.restype = ctypes.c_int64
    lib.bar_utt_frames.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bar_dim.restype = ctypes.c_int64
    lib.bar_dim.argtypes = [ctypes.c_void_p]
    lib.bar_utt_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.bar_utt_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bar_read_batch.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    _lib = lib
    return _lib


class Archive:
    """Read-only archive; native mmap reader with pure-Python fallback."""

    def __init__(self, path, prefer_native: bool = True):
        self.path = str(path)
        self._lib = _load_native() if prefer_native else None
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.bar_open(self.path.encode())
            if not self._handle:
                self._lib = None
        if self._handle:
            n = self._lib.bar_num_utts(self._handle)
            self.keys = [
                self._lib.bar_utt_id(self._handle, i).decode() for i in range(n)
            ]
            self.lengths = np.array(
                [self._lib.bar_utt_frames(self._handle, i) for i in range(n)]
            )
            self.dim = int(self._lib.bar_dim(self._handle))
            self.native = True
        else:
            self._index = self._parse_index()
            self.keys = [k for k, *_ in self._index]
            self.lengths = np.array([nf for _, _, nf, _ in self._index])
            self.dim = self._index[0][3] if self._index else 0
            self._mmap = np.memmap(self.path, np.uint8, mode="r")
            self.native = False

    def _parse_index(self):
        out = []
        with open(self.path, "rb") as fh:
            assert fh.read(8) == _MAGIC, "not a BEER_AR1 archive"
            (n,) = pystruct.unpack("<Q", fh.read(8))
            for _ in range(n):
                (id_len,) = pystruct.unpack("<I", fh.read(4))
                uttid = fh.read(id_len).decode()
                offset, n_frames, dim = pystruct.unpack("<QII", fh.read(16))
                out.append((uttid, offset, n_frames, dim))
        return out

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i: int) -> np.ndarray:
        if self.native:
            n_frames = int(self.lengths[i])
            ptr = self._lib.bar_utt_data(self._handle, i)
            return np.ctypeslib.as_array(ptr, (n_frames, self.dim)).copy()
        _, offset, n_frames, dim = self._index[i]
        raw = self._mmap[offset : offset + n_frames * dim * 4]
        return raw.view(np.float32).reshape(n_frames, dim).copy()

    def padded_batch(self, indices: Sequence[int], t_max: Optional[int] = None):
        """(B, T_max, D) zero-padded batch + (B, T_max) mask."""
        indices = np.asarray(indices, np.int64)
        t_max = t_max or int(self.lengths[indices].max())
        out = np.empty((len(indices), t_max, self.dim), np.float32)
        mask = np.empty((len(indices), t_max), np.float32)
        if self.native:
            self._lib.bar_read_batch(
                self._handle, np.ascontiguousarray(indices), len(indices),
                t_max, out, mask, 8,
            )
        else:
            out[:] = 0.0
            mask[:] = 0.0
            for b, i in enumerate(indices):
                feats = self[int(i)][:t_max]
                out[b, : len(feats)] = feats
                mask[b, : len(feats)] = 1.0
        return out, mask

    def close(self):
        if self.native and self._handle:
            self._lib.bar_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def load_padded(path):
    """(keys, data (B, T, D), mask (B, T)) from a .bar or .npz archive, or
    from an opened .npz."""
    if hasattr(path, "files"):
        archive = path
    elif str(path).endswith(".bar"):
        archive = Archive(str(path))
        data, mask = archive.padded_batch(np.arange(len(archive)))
        return archive.keys, data, mask
    else:
        archive = np.load(str(path))
    keys = list(archive.files)
    lengths = [archive[k].shape[0] for k in keys]
    t_max = max(lengths)
    dim = archive[keys[0]].shape[-1]
    data = np.zeros((len(keys), t_max, dim), np.float32)
    mask = np.zeros((len(keys), t_max), np.float32)
    for i, key in enumerate(keys):
        feats = archive[key]
        data[i, : len(feats)] = feats
        mask[i, : len(feats)] = 1.0
    return keys, data, mask


class BatchLoader:
    """Shuffled epoch iterator with one-batch background prefetch.

    Host-side batch assembly (the native fill) overlaps device compute:
    while the card runs step N, the worker thread builds batch N+1.
    Every batch is a new pair of arrays, never refilled, so a caller may
    upload it asynchronously.

    ``buckets > 1`` enables length bucketing: utterances are partitioned
    by length quantile and every batch is drawn within one bucket,
    padded to that bucket's maximum (rounded up to ``pad_multiple``, so
    there are at most ``buckets`` batch shapes).  Short utterances stop
    paying the longest utterance's padding.
    """

    def __init__(self, archive: Archive, batch_size: int,
                 t_max: Optional[int] = None, seed: int = 0,
                 shuffle: bool = True, buckets: int = 1,
                 pad_multiple: int = 32):
        self.archive = archive
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        lengths = np.asarray(archive.lengths)
        cap = t_max or int(lengths.max())
        buckets = max(1, min(buckets, len(lengths)))
        if buckets > 1:
            edges = np.quantile(lengths, np.linspace(0, 1, buckets + 1)[1:-1])
            bucket_id = np.searchsorted(edges, lengths, side="left")
        else:
            bucket_id = np.zeros(len(lengths), np.int64)
        self.bucket_indices = []
        self.bucket_t_max = []
        for b in range(buckets):
            idx = np.nonzero(bucket_id == b)[0]
            if idx.size == 0:
                continue
            tb = int(lengths[idx].max())
            tb = min(-(-tb // pad_multiple) * pad_multiple, cap)
            self.bucket_indices.append(idx)
            self.bucket_t_max.append(tb)
        self.t_max = cap  # largest shape any batch can take

    def __iter__(self):
        batches = []
        for idx, tb in zip(self.bucket_indices, self.bucket_t_max):
            order = idx.copy()
            if self.shuffle:
                self.rng.shuffle(order)
            batches += [
                (order[i : i + self.batch_size], tb)
                for i in range(0, len(order), self.batch_size)
            ]
        if self.shuffle:
            self.rng.shuffle(batches)
        q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            for idx, tb in batches:
                q.put(self.archive.padded_batch(idx, tb))
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        thread.join()

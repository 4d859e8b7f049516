"""Memory-mapped indexed dataset (counterpart of
``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``, the same file
format; reference ``runtime/data_pipeline/data_sampling/indexed_dataset.py``
— the Megatron-style .bin/.idx pair).

Own on-disk format (not the Megatron binary layout): ``.bin`` holds raw
concatenated token arrays; ``.idx`` holds a header + per-document lengths.
Reads are ``np.memmap`` views, so the dataset never materializes in RAM and
a host can stream arbitrarily large corpora — the property the
reference format exists for.

    builder = MMapIndexedDatasetBuilder("corpus.bin", dtype=np.int32)
    builder.add_item(np.array([...], np.int32))
    builder.finalize("corpus.idx")

    ds = MMapIndexedDataset("corpus")       # or explicit .bin/.idx prefix
    ds[3] -> np.ndarray (zero-copy view); ds.sizes -> per-doc lengths
"""
from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_MAGIC = b"DSTPUIDX"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix if prefix.endswith(".bin") else prefix + ".bin"


def index_file_path(prefix: str) -> str:
    p = prefix[:-4] if prefix.endswith(".bin") else prefix
    return p + ".idx"


class MMapIndexedDatasetBuilder:
    def __init__(self, bin_path: str, dtype=np.int32):
        self._dtype = np.dtype(dtype)
        if self._dtype not in _DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtype}")
        self._bin_path = data_file_path(bin_path)
        self._f = open(self._bin_path, "wb")
        self._sizes = []

    def add_item(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=self._dtype)
        self._f.write(arr.tobytes())
        self._sizes.append(arr.size)

    def add_document(self, arr: np.ndarray) -> None:  # reference alias
        self.add_item(arr)

    def merge_file_(self, other_prefix: str) -> None:
        """Append another dataset's documents (reference builder API)."""
        other = MMapIndexedDataset(other_prefix)
        for i in range(len(other)):
            self.add_item(other[i])

    def finalize(self, idx_path: Optional[str] = None) -> None:
        self._f.close()
        idx_path = idx_path or index_file_path(self._bin_path)
        sizes = np.asarray(self._sizes, np.int64)
        with open(idx_path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<IIQ", _VERSION,
                                _DTYPE_CODES[self._dtype], sizes.size))
            f.write(sizes.tobytes())


class MMapIndexedDataset:
    def __init__(self, prefix: str):
        idx_path = index_file_path(prefix)
        with open(idx_path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{idx_path}: bad magic {magic!r}")
            version, dcode, count = struct.unpack("<IIQ", f.read(16))
            if version != _VERSION:
                raise ValueError(f"{idx_path}: unsupported version {version}")
            self._dtype = np.dtype(_DTYPES[dcode])
            self.sizes = np.frombuffer(f.read(8 * count), np.int64)
        self._pointers = np.zeros(count + 1, np.int64)
        np.cumsum(self.sizes, out=self._pointers[1:])
        bin_path = data_file_path(prefix)
        expected = int(self._pointers[-1]) * self._dtype.itemsize
        actual = os.path.getsize(bin_path)
        if actual != expected:
            raise ValueError(f"{bin_path}: size {actual} != index total "
                             f"{expected} (truncated or mismatched pair)")
        self._data = np.memmap(bin_path, dtype=self._dtype, mode="r")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return self._data[self._pointers[i]:self._pointers[i + 1]]

    def get(self, i: int, offset: int = 0, length: Optional[int] = None):
        doc = self[i]
        return doc[offset:offset + length if length is not None else None]

    @property
    def dtype(self):
        return self._dtype

    @property
    def supports_prefetch(self) -> bool:
        return False  # memmap: the OS page cache is the prefetcher

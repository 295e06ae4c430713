"""A reader for the safetensors format on the standard library and numpy.

The format (https://github.com/huggingface/safetensors) is an 8-byte
little-endian header length N, N bytes of JSON, then one data section.
The JSON maps each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}``, offsets relative to the data section, and may hold a
``"__metadata__"`` object of string pairs.

:class:`SafetensorsFile` maps the file with ``mmap`` and hands out each
tensor as a zero-copy view at its offsets: :meth:`~SafetensorsFile.numpy`
as a numpy array (``BF16`` as its raw ``uint16`` bits, since numpy has no
bfloat16) and :meth:`~SafetensorsFile.tensor` as a CPU torch tensor
(``BF16`` reinterpreted as ``torch.bfloat16`` with ``.view``, no float
round trip). The mapping is private and copy-on-write, so a view is
writable and a write never reaches the file. Views keep the mapping alive.

Every header is checked before any view is made: a malformed header,
an unknown dtype, a shape that does not fill its offsets, and offsets
that overlap or leave the data section raise ``ValueError`` naming the
tensor.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator

import numpy as np
import torch

# safetensors dtype -> the numpy dtype of its raw elements
DTYPES: Dict[str, np.dtype] = {
    "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"), "I8": np.dtype("i1"), "I32": np.dtype("<i4"),
    "I64": np.dtype("<i8"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
# the library refuses headers past 100 MB; so does this reader
MAX_HEADER_BYTES = 100_000_000


class SafetensorsFile:
    """One ``.safetensors`` file, mapped (private, copy-on-write) for its
    views."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: {size} bytes, shorter than the "
                                 f"8-byte header length")
            (n,) = struct.unpack("<Q", fh.read(8))
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise ValueError(f"{path}: header length {n} does not fit a "
                                 f"file of {size} bytes")
            raw = fh.read(n)
            self._start = 8 + n
            self._entries, self.metadata = _parse_header(
                path, raw, size - self._start)
            # a zero-byte data section cannot be mapped; its tensors are
            # all empty
            self._map = (mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size > self._start else None)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def dtype(self, name: str) -> str:
        return self._entries[name][0]

    def numpy(self, name: str) -> np.ndarray:
        """Zero-copy numpy view of ``name`` (``BF16`` as ``uint16``)."""
        dtype, shape, begin, end = self._entries[name]
        npt = DTYPES[dtype]
        if begin == end:
            return np.zeros(shape, npt)
        return np.frombuffer(self._map, dtype=npt,
                             count=(end - begin) // npt.itemsize,
                             offset=self._start + begin).reshape(shape)

    def tensor(self, name: str) -> torch.Tensor:
        """Zero-copy CPU tensor of ``name``; ``BF16`` is viewed as
        ``torch.bfloat16``."""
        t = torch.from_numpy(self.numpy(name))
        return t.view(torch.bfloat16) if self.dtype(name) == "BF16" else t


def _parse_header(path: str, raw: bytes, data_len: int):
    """(name -> (dtype, shape, begin, end), metadata) of a header, checked
    against a data section of ``data_len`` bytes."""
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ValueError(f"{path}: the header is not JSON ({exc})") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    if not (isinstance(metadata, dict)
            and all(isinstance(k, str) and isinstance(v, str)
                    for k, v in metadata.items())):
        raise ValueError(f"{path}: __metadata__ must map strings to strings")
    entries = {}
    for name, info in header.items():
        where = f"{path}: tensor {name!r}"
        if not isinstance(info, dict) or not {"dtype", "shape",
                                              "data_offsets"} <= set(info):
            raise ValueError(f"{where}: needs dtype, shape and data_offsets")
        dtype, shape, offsets = (info["dtype"], info["shape"],
                                 info["data_offsets"])
        if dtype not in DTYPES:
            raise ValueError(f"{where}: unknown dtype {dtype!r} (known: "
                             f"{sorted(DTYPES)})")
        if not (isinstance(shape, list)
                and all(type(d) is int and d >= 0 for d in shape)):
            raise ValueError(f"{where}: bad shape {shape!r}")
        if not (isinstance(offsets, list) and len(offsets) == 2
                and all(type(o) is int for o in offsets)):
            raise ValueError(f"{where}: bad data_offsets {offsets!r}")
        begin, end = offsets
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{where}: data_offsets {offsets} out of range "
                             f"of a {data_len}-byte data section")
        nbytes = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype].itemsize
        if end - begin != nbytes:
            raise ValueError(f"{where}: {dtype} {shape} needs {nbytes} bytes, "
                             f"data_offsets hold {end - begin}")
        entries[name] = (dtype, tuple(shape), begin, end)
    spans = sorted((b, e, n) for n, (_, _, b, e) in entries.items() if e > b)
    for (_, prev_end, prev), (begin, _, name) in zip(spans, spans[1:]):
        if begin < prev_end:
            raise ValueError(f"{path}: tensor {name!r} overlaps tensor "
                             f"{prev!r}")
    return entries, metadata

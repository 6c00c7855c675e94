"""The likelihood file (``likelihood_K{k}_{run}.h5``) in plain numpy and the
standard library: HDF5 that h5py reads as it reads the JAX logger's file,
written and read without h5py (the card's machine has none).

The file holds the JAX logger's two datasets in the root group:
``na_values`` (N*F,) as h5py's bool (an enum over int8 with members FALSE
= 0 and TRUE = 1, which h5py reads as numpy ``bool``) and ``likelihood``
(samples, N*F), float32 little-endian, row-major. Both are contiguous and
uncompressed (the JAX logger's file is chunked and gzip-compressed: the same
values in a larger file). The layout is HDF5's oldest, as h5py writes by
default: superblock version 0, the root group as a symbol table (a v1
B-tree node, a local heap and one symbol table node), version 1 object
headers. ``likelihood``'s data are the last bytes of the file, so an append
writes its row at the end and then patches three fixed-width fields in
place: the dataspace's first dimension, the layout's data size (and its
address at the first row: a dataset of no rows has the undefined address)
and the superblock's end-of-file address.

The reader reads any file of that layout with contiguous, unfiltered
datasets of integer, float or h5py-bool type, and raises
``UnsupportedLayout`` for the rest of HDF5 (chunked or filtered data, a newer
superblock or object header), which only h5py reads.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFF_FFFF_FFFF_FFFF
LEAF_K, INTERNAL_K = 4, 16         # the symbol table's node sizes (HDF5's defaults)
EOF_FIELD = 40                     # the superblock's end-of-file address

MSG_DATASPACE, MSG_DATATYPE, MSG_FILL, MSG_LAYOUT = 0x01, 0x03, 0x05, 0x08
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x0B, 0x10, 0x11

_BOOL_MEMBERS = {"FALSE": 0, "TRUE": 1}


class UnsupportedLayout(ValueError):
    """An HDF5 file (or a dataset in it) in a layout this module does not
    read or append to."""


# -------------------- writing --------------------

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(kind: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _object_header(*messages: bytes) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataspace(dims) -> bytes:
    return struct.pack("<BBBB4x", 1, len(dims), 0, 0) + struct.pack(f"<{len(dims)}Q", *dims)


F32_TYPE = bytes.fromhex("11201f00") + struct.pack("<IHHBBBBI", 4, 0, 32, 23, 8, 0, 23, 127)
INT8_TYPE = bytes.fromhex("10080000") + struct.pack("<IHH", 1, 0, 8)
BOOL_TYPE = (bytes.fromhex("18020000") + struct.pack("<I", 1) + INT8_TYPE
             + b"FALSE\0\0\0" + b"TRUE\0\0\0\0" + bytes([0, 1]))
FILL = bytes.fromhex("0202020100000000")   # version 2, allocated late, no fill value


def _dataset_header(dims, datatype: bytes, address: int, size: int) -> bytes:
    return _object_header(_message(MSG_DATASPACE, _dataspace(dims)),
                          _message(MSG_DATATYPE, datatype, flags=1),
                          _message(MSG_FILL, FILL, flags=1),
                          _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, address, size)))


def _file_image(na_values: np.ndarray) -> bytes:
    """The bytes of a file with ``na_values`` (N*F,) and a ``likelihood`` of
    no rows of N*F columns."""
    root, btree = 96, 136
    heap = btree + 24 + (4 * INTERNAL_K + 1) * 8
    heap_data = heap + 32
    # the heap's names: "" (the root's), then both datasets'; a free block after
    names = b"\0" * 8 + _pad8(b"na_values\0") + _pad8(b"likelihood\0")
    free = len(names)
    names += struct.pack("<QQ", 1, 48)
    names += b"\0" * (48 - 16)
    snod = heap_data + len(names)
    na_header = snod + 8 + 2 * LEAF_K * 40
    n = na_values.size
    lh_header = na_header + len(_dataset_header([n], BOOL_TYPE, 0, 0))
    na_data = lh_header + len(_dataset_header([0, n], F32_TYPE, 0, 0))
    eof = na_data + n

    def entry(name_offset: int, header: int, cache: int = 0, scratch: bytes = b"\0" * 16):
        return struct.pack("<QQII", name_offset, header, cache, 0) + scratch

    stab = struct.pack("<QQ", btree, heap)
    parts = [
        (0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
         + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
         + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED) + entry(0, root, 1, stab)),
        (root, _object_header(_message(MSG_SYMBOL_TABLE, stab))),
        # one leaf node: key 0 (""), the symbol table node, key of its last name
        (btree, b"TREE" + struct.pack("<BBHQQQQQ", 0, 0, 1, UNDEFINED, UNDEFINED, 0, snod, 8)),
        (heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(names), free, heap_data)),
        (heap_data, names),
        # entries sorted by name: likelihood, na_values
        (snod, b"SNOD" + struct.pack("<BBH", 1, 0, 2) + entry(24, lh_header) + entry(8, na_header)),
        (na_header, _dataset_header([n], BOOL_TYPE, na_data, n)),
        (lh_header, _dataset_header([0, n], F32_TYPE, UNDEFINED, 0)),
        (na_data, na_values.astype(np.int8).tobytes()),
    ]
    image = bytearray(eof)
    for offset, data in parts:
        image[offset:offset + len(data)] = data
    return bytes(image)


class LikelihoodFile:
    """A likelihood file open for appending rows (one per sample)."""

    def __init__(self, path, likelihood: "_Dataset", eof: int):
        self.path = Path(path)
        self.ds = likelihood
        self.n_columns = likelihood.shape[1]
        self.rows = likelihood.shape[0]
        self.end = eof
        self.file = open(self.path, "r+b")

    @classmethod
    def create(cls, path, na_values) -> "LikelihoodFile":
        """A new file (replacing any at ``path``) with ``na_values`` and no rows."""
        na = np.asarray(na_values, dtype=bool).ravel()
        Path(path).write_bytes(_file_image(na))
        return cls.append_to(path, na.size)

    @classmethod
    def append_to(cls, path, n_columns: int) -> "LikelihoodFile":
        """An existing file, when its ``likelihood`` is float32 (rows,
        ``n_columns``), contiguous and the last data of the file; else
        ``UnsupportedLayout`` (as for a file h5py wrote chunked)."""
        with open(path, "rb") as f:
            eof, datasets = _parse(f)
            size = f.seek(0, 2)
        ds = datasets.get("likelihood")
        if ds is None:
            raise UnsupportedLayout(f"{path}: no `likelihood` dataset")
        if ds.dtype != np.dtype("<f4") or len(ds.shape) != 2 or ds.shape[1] != n_columns:
            raise UnsupportedLayout(f"{path}: `likelihood` is {ds.dtype} {ds.shape}, "
                                    f"not float32 (rows, {n_columns})")
        at_end = ds.address == UNDEFINED if ds.shape[0] == 0 else (
            ds.address + ds.nbytes == size)
        if eof != size or not at_end:
            raise UnsupportedLayout(f"{path}: `likelihood`'s data are not the end of the file")
        return cls(path, ds, eof)

    def _put(self, offset: int, fmt: str, value: int):
        self.file.seek(offset)
        self.file.write(struct.pack(fmt, value))

    def append(self, row):
        """Write one row at the end of the file, then the fields that count it."""
        row = np.ascontiguousarray(row, dtype="<f4").ravel()
        if row.size != self.n_columns:
            raise ValueError(f"a row of {row.size} values for {self.n_columns} columns")
        ds = self.ds
        if self.rows == 0:
            self._put(ds.address_field, "<Q", self.end)
        self.file.seek(self.end)
        self.file.write(row.tobytes())
        self.end += row.nbytes
        self.rows += 1
        for field in ds.first_dim_fields:
            self._put(field, "<Q", self.rows)
        self._put(ds.address_field + 8, "<Q", self.rows * row.nbytes)
        self._put(EOF_FIELD, "<Q", self.end)
        self.file.flush()

    def close(self):
        self.file.close()


# -------------------- reading --------------------

@dataclass
class _Dataset:
    shape: tuple
    dtype: np.dtype             # as h5py reads it (bool for h5py's bool enum)
    storage: np.dtype           # as stored
    address: int
    nbytes: int
    # file offsets of the fields an append patches: the layout's data
    # address (its size follows), the first dimension and its maximum
    address_field: int
    first_dim_fields: tuple


def _read(f, offset: int, n: int) -> bytes:
    f.seek(offset)
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"truncated HDF5 file: {n} bytes at {offset}")
    return b


def _messages(f, address: int) -> list:
    """(type, offset of the data, data) of each message of a version 1
    object header, its continuation blocks included."""
    prefix = _read(f, address, 16)
    if prefix[0] != 1:
        raise UnsupportedLayout(f"object header version {prefix[0]} at {address}")
    blocks = [(address + 16, struct.unpack_from("<I", prefix, 8)[0])]
    out = []
    while blocks:
        start, length = blocks.pop(0)
        data = _read(f, start, length)
        p = 0
        while p + 8 <= length:
            kind, size = struct.unpack_from("<HH", data, p)
            body = data[p + 8:p + 8 + size]
            if kind == MSG_CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", body))
            else:
                out.append((kind, start + p + 8, body))
            p += 8 + size
    return out


def _dtype(body: bytes) -> tuple:
    """(numpy type, stored numpy type, bytes of the datatype message read)."""
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits, size = body[1], struct.unpack_from("<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        t = np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        return t, t, 12
    if cls == 1 and not bits & 0x40 and size in (2, 4, 8):
        t = np.dtype(f"{order}f{size}")
        return t, t, 20
    if cls == 8:
        base, _, n_base = _dtype(body[8:])
        n = body[1] | body[2] << 8
        p, names = 8 + n_base, []
        for _ in range(n):
            end = body.index(b"\0", p)
            names.append(body[p:end].decode())
            # versions 1 and 2 pad each name to a multiple of 8 bytes
            p = end + 1 if version >= 3 else p + len(_pad8(body[p:end + 1]))
        values = np.frombuffer(body, dtype=base, count=n, offset=p).tolist()
        if dict(zip(names, values)) != _BOOL_MEMBERS:
            raise UnsupportedLayout(f"an enum datatype other than h5py's bool: {names}")
        return np.dtype(bool), base, p + n * base.itemsize
    raise UnsupportedLayout(f"datatype class {cls} (size {size})")


def _dataset(f, address: int) -> Optional[_Dataset]:
    """The dataset whose object header is at ``address``; None for another
    object (a group)."""
    msgs = {kind: (pos, body) for kind, pos, body in _messages(f, address)}
    if MSG_LAYOUT not in msgs:
        return None
    if MSG_FILTERS in msgs:
        raise UnsupportedLayout("a filtered (compressed) dataset")
    pos, body = msgs[MSG_DATASPACE]
    version, rank, flags = body[0], body[1], body[2]
    if version not in (1, 2):
        raise UnsupportedLayout(f"dataspace version {version}")
    dims_at = 8 if version == 1 else 4
    shape = struct.unpack_from(f"<{rank}Q", body, dims_at)
    first_dims = (pos + dims_at,) if rank else ()
    if flags & 1 and rank:                               # the maximum dimensions
        first_dims += (pos + dims_at + 8 * rank,)
    dtype, storage, _ = _dtype(msgs[MSG_DATATYPE][1])
    pos, body = msgs[MSG_LAYOUT]
    version, layout = body[0], body[1]
    if version not in (3, 4) or layout != 1:
        raise UnsupportedLayout(f"data layout version {version}, class {layout} (compact, "
                                f"chunked or virtual: h5py reads it)")
    address, nbytes = struct.unpack_from("<QQ", body, 2)
    return _Dataset(tuple(shape), dtype, storage, address, nbytes, pos + 2, first_dims)


def _parse(f) -> tuple:
    """(end-of-file address, {name: _Dataset} of the root group)."""
    sb = _read(f, 0, 96)
    if sb[:8] != SIGNATURE:
        raise UnsupportedLayout("no HDF5 signature at the start of the file")
    if sb[8] != 0:
        raise UnsupportedLayout(f"superblock version {sb[8]}")
    if sb[13] != 8 or sb[14] != 8:
        raise UnsupportedLayout(f"offsets of {sb[13]} and lengths of {sb[14]} bytes")
    _, internal_k = struct.unpack_from("<HH", sb, 16)
    (eof,) = struct.unpack_from("<Q", sb, EOF_FIELD)
    (root,) = struct.unpack_from("<Q", sb, 64)
    stab = [body for kind, _, body in _messages(f, root) if kind == MSG_SYMBOL_TABLE]
    if not stab:
        raise UnsupportedLayout("a root group without a symbol table")
    btree, heap = struct.unpack_from("<QQ", stab[0])
    head = _read(f, heap, 32)
    if head[:4] != b"HEAP":
        raise ValueError(f"no local heap at {heap}")
    heap_size, _, heap_data = struct.unpack_from("<QQQ", head, 8)
    names = _read(f, heap_data, heap_size)
    datasets = {}
    nodes = [btree]
    while nodes:
        node = _read(f, nodes.pop(0), 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise ValueError("a corrupt group B-tree")
        level, n = node[5], struct.unpack_from("<H", node, 6)[0]
        if n > 2 * internal_k:
            raise ValueError("a corrupt group B-tree")
        keys = struct.unpack_from(f"<{2 * n + 1}Q", _read(f, f.tell(), (2 * n + 1) * 8))
        children = list(keys[1::2])
        if level > 0:
            nodes += children
            continue
        for child in children:
            snod = _read(f, child, 8)
            if snod[:4] != b"SNOD":
                raise ValueError(f"no symbol table node at {child}")
            n_symbols = struct.unpack_from("<H", snod, 6)[0]
            entries = _read(f, child + 8, 40 * n_symbols)
            for i in range(n_symbols):
                name_offset, header = struct.unpack_from("<QQ", entries, 40 * i)
                name = names[name_offset:names.index(b"\0", name_offset)].decode()
                ds = _dataset(f, header)
                if ds is not None:
                    datasets[name] = ds
    return eof, datasets


def read_datasets(path) -> dict:
    """{name: array} of every dataset in the root group of ``path``;
    ``UnsupportedLayout`` where one is not contiguous and unfiltered (h5py
    reads those)."""
    with open(path, "rb") as f:
        eof, datasets = _parse(f)
        size = f.seek(0, 2)
        out = {}
        for name, ds in datasets.items():
            count = int(np.prod(ds.shape))
            if ds.address == UNDEFINED:
                raw = np.zeros(count, dtype=ds.storage)
            else:
                if ds.nbytes < count * ds.storage.itemsize or ds.address + ds.nbytes > min(eof, size):
                    raise ValueError(f"{path}: `{name}` runs past the end of the file")
                raw = np.frombuffer(_read(f, ds.address, count * ds.storage.itemsize),
                                    dtype=ds.storage)
            out[name] = (raw != 0 if ds.dtype == np.dtype(bool) else raw).reshape(ds.shape)
    return out

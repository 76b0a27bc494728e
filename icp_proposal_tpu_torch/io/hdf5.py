"""A minimal HDF5 reader and writer in numpy, for the statismo layout.

The H100 host has no ``h5py``, and the port installs nothing, so the
statismo files (``io/statismo.py``) go through this module.  It covers the
part of the HDF5 format (version 0 superblock, version 1 object headers,
symbol-table groups) that the HDF5 library writes by default, which is
what ``h5py`` writes unless told otherwise:

* read: groups and their datasets of fixed-point, floating-point or
  fixed-length string type, contiguous and unfiltered, with any number of
  continuation blocks in their object headers; attributes are not read;
  asked for named datasets, it opens only the groups on their paths, so
  other objects in the file may be of any kind;
* write: nested groups of such datasets (contiguous) and scalar attributes
  on groups, readable by ``h5py`` and the HDF5 library.

Anything else on the way to a dataset that is read (another superblock
version, version 2 object headers, link messages, compact, chunked or
filtered data) raises ``ValueError``: such a file must be rewritten with
contiguous, unfiltered datasets first (``h5repack -l CONTI`` or ``h5py``).
The writer takes up to 256 members a group.
"""
from __future__ import annotations

import struct
from typing import Dict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16  # the library's defaults: 8 symbols a node, 32 children
_ENTRY = 40  # a symbol table entry with 8-byte offsets
_BTREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
_SNOD_SIZE = 8 + 2 * LEAF_K * _ENTRY

# message types
_NIL, _DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x0, 0x1, 0x3, 0x5, 0x8
_FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0xB, 0xC, 0x10, 0x11
_LINK, _LINK_INFO = 0x6, 0x2


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _File:
    def __init__(self, data: bytes):
        self.data = data

    def u(self, off: int, n: int) -> int:
        return int.from_bytes(self.data[off:off + n], "little")

    def messages(self, addr: int):
        """The (type, body) of each message of the version 1 object header
        at ``addr``, continuation blocks followed."""
        d = self.data
        if d[addr:addr + 4] == b"OHDR":
            raise ValueError("HDF5: version 2 object headers are not supported")
        if d[addr] != 1:
            raise ValueError(f"HDF5: object header version {d[addr]} at {addr}")
        n_msgs = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            pos = start
            while pos + 8 <= start + size and len(out) < n_msgs:
                mtype, msize = self.u(pos, 2), self.u(pos + 2, 2)
                body = d[pos + 8:pos + 8 + msize]
                out.append((mtype, body))
                if mtype == _CONTINUATION:
                    blocks.append((int.from_bytes(body[0:8], "little"),
                                   int.from_bytes(body[8:16], "little")))
                pos += 8 + msize
        return [(t, b) for t, b in out if t not in (_NIL, _CONTINUATION)]

    def heap_name(self, heap: int, offset: int) -> str:
        if self.data[heap:heap + 4] != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {heap}")
        start = self.u(heap + 24, 8) + offset
        end = self.data.index(b"\0", start)
        return self.data[start:end].decode("utf-8")

    def group_links(self, btree: int, heap: int) -> Dict[str, int]:
        """name → object header address of a symbol-table group."""
        d = self.data
        if d[btree:btree + 4] != b"TREE" or d[btree + 4] != 0:
            raise ValueError(f"HDF5: no group B-tree node at {btree}")
        links = {}
        for i in range(self.u(btree + 6, 2)):
            child = self.u(btree + 24 + 8 + 16 * i, 8)
            if d[btree + 5] > 0:  # an inner node: its children are nodes
                links.update(self.group_links(child, heap))
                continue
            if d[child:child + 4] != b"SNOD":
                raise ValueError(f"HDF5: no symbol table node at {child}")
            for k in range(self.u(child + 6, 2)):
                e = child + 8 + _ENTRY * k
                links[self.heap_name(heap, self.u(e, 8))] = self.u(e + 8, 8)
        return links

    def walk(self, addr: int, prefix: str, out: dict, wanted):
        """Decode the datasets under the object at ``addr`` into ``out``;
        with ``wanted`` (a set of paths) only the groups on the way to a
        wanted path are opened and only wanted datasets decoded."""
        msgs = self.messages(addr)
        types = {t for t, _ in msgs}
        if _SYMBOL_TABLE in types:
            body = next(b for t, b in msgs if t == _SYMBOL_TABLE)
            links = self.group_links(int.from_bytes(body[0:8], "little"),
                                     int.from_bytes(body[8:16], "little"))
            for name, child in links.items():
                path = f"{prefix}{name}"
                if wanted is None or path in wanted or any(
                        w.startswith(path + "/") for w in wanted):
                    self.walk(child, path + "/", out, wanted)
        elif _LINK in types or _LINK_INFO in types:
            raise ValueError("HDF5: groups stored as link messages are not supported")
        elif _LAYOUT in types:
            out[prefix.rstrip("/")] = self.dataset(msgs)

    def dataset(self, msgs) -> np.ndarray:
        body = dict(msgs)
        if _FILTERS in body:
            raise ValueError("HDF5: filtered datasets are not supported")
        shape = _dataspace(body[_DATASPACE])
        dtype = _datatype(body[_DATATYPE])
        lay = body[_LAYOUT]
        if lay[0] != 3 or lay[1] != 1:
            raise ValueError(f"HDF5: data layout version {lay[0]} class {lay[1]} (only "
                             "contiguous data of layout version 3 are supported)")
        addr = int.from_bytes(lay[2:10], "little")
        count = int(np.prod(shape, dtype=np.int64))
        raw = self.data[addr:addr + count * dtype.itemsize]
        return np.frombuffer(raw, dtype, count=count).reshape(shape).copy()


def _dataspace(body: bytes):
    version, rank = body[0], body[1]
    start = {1: 8, 2: 4}.get(version)
    if start is None:
        raise ValueError(f"HDF5: dataspace message version {version}")
    return tuple(int.from_bytes(body[start + 8 * i:start + 8 * i + 8], "little")
                 for i in range(rank))


def _datatype(body: bytes) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, body[1], int.from_bytes(body[4:8], "little")
    if cls in (0, 1) and bits & 1:
        raise ValueError("HDF5: big-endian data are not supported")
    if cls == 0:
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        return np.dtype(f"<f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    raise ValueError(f"HDF5: datatype class {cls} is not supported")


def read_datasets(path, names=None) -> Dict[str, np.ndarray]:
    """The datasets of an HDF5 file → {"group/…/name": array}: those at
    ``names`` (a missing one raises ``KeyError``), or every one when
    ``names`` is None.  Objects off the paths to ``names`` are not read, so
    a format this module does not cover elsewhere in the file is no
    obstacle."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not an HDF5 file (no signature at offset 0)")
    if data[8] != 0 or data[13] != 8 or data[14] != 8:
        raise ValueError(f"{path}: HDF5 superblock version {data[8]} or sizes "
                         f"{data[13]}/{data[14]} are not supported")
    wanted = None if names is None else {n.strip("/") for n in names}
    fh = _File(data)
    out: Dict[str, np.ndarray] = {}
    fh.walk(fh.u(56 + 8, 8), "", out, wanted)  # the root group's symbol table entry
    missing = sorted((wanted or set()) - set(out))
    if missing:
        raise KeyError(f"{path}: no dataset {', '.join(missing)}")
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _msg(mtype: int, body: bytes) -> bytes:
    body = body + b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _type_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        exp = {4: (23, 8, 127), 8: (52, 11, 1023)}[size]
        return (struct.pack("<BBBBI", 0x11, 0x20, 8 * size - 1, 0, size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp[0], exp[1], 0, exp[0], exp[2]))
    if dtype.kind in "iu":
        return (struct.pack("<BBBBI", 0x10, 0x08 if dtype.kind == "i" else 0, 0, 0, size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)  # null-padded ASCII
    raise ValueError(f"HDF5: cannot write dtype {dtype}")


def _space_message(shape) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)  # the superblock, filled in last

    def alloc(self, blob: bytes) -> int:
        addr = len(self.buf)
        self.buf += blob + b"\0" * (-len(blob) % 8)
        return addr

    def dataset(self, array: np.ndarray) -> int:
        array = np.asarray(array, order="C")  # keeps a scalar 0-d
        if array.dtype.byteorder == ">":
            array = array.astype(array.dtype.newbyteorder("<"))
        data_addr = self.alloc(array.tobytes())
        return self.alloc(_header([
            _msg(_DATASPACE, _space_message(array.shape)),
            _msg(_DATATYPE, _type_message(array.dtype)),
            _msg(_FILL, bytes([2, 2, 2, 0])),  # late allocation, never filled
            _msg(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, array.nbytes)),
        ]))

    def group(self, tree: dict, attrs: dict, prefix: str):
        """Write a group's children (``tree``: name → subtree or array),
        then its heap, nodes and header → (header, B-tree, heap) addresses."""
        names = sorted(tree, key=lambda n: n.encode("utf-8"))
        children = {}
        for name in names:
            sub = tree[name]
            path = f"{prefix}{name}"
            children[name] = (self.group(sub, attrs, path + "/") if isinstance(sub, dict)
                              else (self.dataset(sub), None, None))
        heap_data, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap_data)
            raw = name.encode("utf-8") + b"\0"
            heap_data += raw + b"\0" * (-len(raw) % 8)
        # one free block closes the heap, as the library writes it: the next
        # free block's offset (1, the library's end of list) and its size
        free = len(heap_data)
        heap_data += struct.pack("<QQ", 1, 16)
        data_addr = self.alloc(bytes(heap_data))
        heap = self.alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), free,
                                                data_addr))
        leaves = [names[i:i + 2 * LEAF_K] for i in range(0, len(names), 2 * LEAF_K)]
        if len(leaves) > 2 * INTERNAL_K:
            raise ValueError(f"HDF5: a group of {len(names)} members is too large")
        snods = []
        for leaf in leaves:
            entries = b"".join(
                struct.pack("<QQI4x", offsets[n], children[n][0],
                            0 if children[n][1] is None else 1)
                + (struct.pack("<QQ", *children[n][1:]) if children[n][1] is not None
                   else b"\0" * 16)
                for n in leaf)
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(leaf)) + entries
            snods.append(self.alloc(node + b"\0" * (_SNOD_SIZE - len(node))))
        keys = [0] + [offsets[leaf[-1]] for leaf in leaves]
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(leaves), UNDEF, UNDEF)
        node += struct.pack("<Q", keys[0]) + b"".join(
            struct.pack("<QQ", child, key) for child, key in zip(snods, keys[1:]))
        btree = self.alloc(node + b"\0" * (_BTREE_SIZE - len(node)))
        msgs = [_msg(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]
        for aname, value in attrs.get(prefix.rstrip("/"), {}).items():
            value = np.asarray(value)
            name = aname.encode("utf-8") + b"\0"
            dtype, space = _type_message(value.dtype), _space_message(value.shape)
            msgs.append(_msg(_ATTRIBUTE, b"".join([
                struct.pack("<BBHHH", 1, 0, len(name), len(dtype), len(space)),
                *(x + b"\0" * (-len(x) % 8) for x in (name, dtype, space)),
                value.tobytes()])))
        return self.alloc(_header(msgs)), btree, heap


def write_datasets(path, datasets: Dict[str, np.ndarray],
                   group_attrs: Dict[str, Dict[str, np.ndarray]] | None = None) -> None:
    """Write arrays at their "group/…/name" paths (groups created as
    needed), plus scalar attributes on groups (``{"group": {"name":
    value}}``), as an HDF5 file."""
    tree: dict = {}
    for key, array in datasets.items():
        *groups, name = key.strip("/").split("/")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[name] = np.asarray(array)
    w = _Writer()
    header, btree, heap = w.group(tree, group_attrs or {}, "")
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K,
                                 INTERNAL_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, len(w.buf), UNDEF)
    sb += struct.pack("<QQI4xQQ", 0, header, 1, btree, heap)
    w.buf[:96] = sb
    with open(path, "wb") as f:
        f.write(bytes(w.buf))

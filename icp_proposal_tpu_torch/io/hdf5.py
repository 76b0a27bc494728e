"""An HDF5 reader and a minimal writer in numpy, for the statismo layout.

The H100 host has no ``h5py``, and the port installs nothing, so the
statismo files (``io/statismo.py``) go through this module.  The reader
follows the HDF5 File Format Specification (version 3.0) as far as the
datasets of a model file need it, so it reads what ``h5py`` and the HDF5
library write, whatever the library version bounds or dataset options:

* superblocks of versions 0–3 with 8-byte offsets and lengths, after a
  user block of any size;
* object headers of versions 1 and 2, with their continuation blocks and
  shared (committed) datatypes;
* groups stored as symbol tables, as link messages (compact) or in a
  fractal heap indexed by a version 2 B-tree (dense); hard and soft links;
* data layout messages of versions 1–4: compact, contiguous and chunked
  data, the chunks indexed by a version 1 B-tree, a single chunk, an
  implicit index, a fixed array, an extensible array or a version 2
  B-tree; partial edge chunks; storage never written reads as the fill
  value (0 unless the file sets one);
* the deflate, shuffle and fletcher32 filters (``zlib`` from the standard
  library; a fletcher32 mismatch raises);
* fixed-point, IEEE floating-point and fixed-length string types in
  either byte order (returned in native order).

Checksums of metadata are not verified.  Attributes are not read.  These
raise ``ValueError`` naming what they met, when a dataset that is read
needs them: other filters (szip, nbit, scale-offset, lzf, any plugin),
variable-length, compound, enum, array, opaque, reference, time and
bitfield types, external and user-defined links, virtual datasets, shared
messages kept in a shared-message heap, fractal-heap objects stored as
"huge", and superblocks with other than 8-byte offsets or lengths.  Asked
for named datasets, the reader opens only the groups on their paths, so
other objects in the file may be of any kind.

The writer writes nested groups of contiguous datasets and scalar
attributes on groups in the layout that ``h5py`` writes by default,
readable by ``h5py`` and the HDF5 library; it takes up to 256 members a
group.
"""
from __future__ import annotations

import bisect
import mmap
import struct
import zlib
from typing import Dict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16  # the library's defaults: 8 symbols a node, 32 children
_ENTRY = 40  # a symbol table entry with 8-byte offsets
_BTREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
_SNOD_SIZE = 8 + 2 * LEAF_K * _ENTRY

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0x6, 0x8, 0xB, 0xC, 0x10, 0x11

_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scale-offset", 32000: "lzf"}
_TYPE_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
               8: "enum", 9: "variable-length", 10: "array"}
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}  # exp loc/size,
# mantissa size, bias


class UnsupportedType(ValueError):
    """A dataset whose datatype or dataspace the reader does not decode."""


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _u(b, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def _enc_size(n: int) -> int:
    """Bytes the library uses to store a count up to ``n``."""
    return _log2(max(n, 1)) // 8 + 1


class _File:
    """One open file: every address it returns is absolute (the base address,
    where the superblock lies, added)."""

    def __init__(self, data, name):
        self.data, self.name = data, name
        self._headers, self._links = {}, {}
        sb = 0
        while data[sb:sb + 8] != SIGNATURE:
            sb = 512 if sb == 0 else 2 * sb
            if sb + 8 > len(data):
                raise ValueError(f"{name}: not an HDF5 file (no signature)")
        self.base = sb
        version = data[sb + 8]
        if version in (0, 1):
            sizes = data[sb + 13], data[sb + 14]
            self.root = self.addr(sb + (24 if version == 0 else 28) + 32 + 8)
        elif version in (2, 3):
            sizes = data[sb + 9], data[sb + 10]
            self.root = self.addr(sb + 36)
        else:
            raise ValueError(f"{name}: HDF5 superblock version {version}")
        if sizes != (8, 8):
            raise ValueError(f"{name}: HDF5 offsets and lengths of {sizes[0]}/{sizes[1]} "
                             "bytes (only 8/8 are read)")

    def u(self, off: int, n: int) -> int:
        return _u(self.data, off, n)

    def addr(self, off: int):
        """The address stored at ``off``, absolute, or None when undefined."""
        return self.addr_of(self.u(off, 8))

    def addr_of(self, value: int):
        return None if value == UNDEF else self.base + value

    def check(self, addr: int, sig: bytes):
        if self.data[addr:addr + 4] != sig:
            raise ValueError(f"{self.name}: no {sig.decode()} block at {addr}")

    # -- object headers ----------------------------------------------------

    def header(self, addr: int):
        """The (type, body) of each message of the object header at
        ``addr`` (version 1 or 2), continuation blocks followed, shared
        messages resolved."""
        if addr in self._headers:
            return self._headers[addr]
        d = self.data
        if d[addr:addr + 4] == b"OHDR":
            flags = d[addr + 5]
            pos = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            blocks = [(pos + width, self.u(pos, width))]
            prefix = 6 if flags & 0x04 else 4
        elif d[addr] == 1:
            blocks = [(addr + 16, self.u(addr + 8, 4))]
            flags, prefix = None, 8
        else:
            raise ValueError(f"{self.name}: object header version {d[addr]} at {addr}")
        out = []
        while blocks:
            start, size = blocks.pop(0)
            pos, end = start, start + size
            while pos + prefix <= end:
                if flags is None:
                    mtype, msize, mflags = self.u(pos, 2), self.u(pos + 2, 2), d[pos + 4]
                else:
                    mtype, msize, mflags = d[pos], self.u(pos + 1, 2), d[pos + 3]
                body = d[pos + prefix:pos + prefix + msize]
                pos += prefix + msize
                if mtype == _CONTINUATION:
                    cont, length = self.addr_of(_u(body, 0, 8)), _u(body, 8, 8)
                    if flags is None:
                        blocks.append((cont, length))
                    else:  # "OCHK", messages, checksum
                        self.check(cont, b"OCHK")
                        blocks.append((cont + 4, length - 8))
                elif mtype != _NIL:
                    out.append((mtype, self.shared(mtype, body) if mflags & 0x02 else body))
        self._headers[addr] = out
        return out

    def shared(self, mtype: int, body: bytes) -> bytes:
        """The message a shared message points to (a committed datatype)."""
        version, kind = body[0], body[1]
        if version == 1:
            where = _u(body, 16, 8)
        elif version in (2, 3) and kind != 1:
            where = _u(body, 2, 8)
        else:
            raise ValueError(f"{self.name}: shared messages kept in a shared-message heap "
                             "are not supported")
        for t, b in self.header(self.addr_of(where)):
            if t == mtype:
                return b
        raise ValueError(f"{self.name}: shared message of type {mtype} not found")

    # -- groups ------------------------------------------------------------

    def links(self, addr: int) -> dict:
        """name → link of the group at ``addr`` ({} for another object): a
        link is ("hard", address), ("soft", path) or (kind, None)."""
        if addr in self._links:
            return self._links[addr]
        msgs = self.header(addr)
        out = {}
        for mtype, body in msgs:
            if mtype == _SYMBOL_TABLE:
                out.update(self.symbol_table(self.addr_of(_u(body, 0, 8)),
                                             self.addr_of(_u(body, 8, 8))))
            elif mtype == _LINK:
                name, link = self.link(body)
                out[name] = link
            elif mtype == _LINK_INFO:
                pos = 2 + (8 if body[1] & 1 else 0)
                heap, names = self.addr_of(_u(body, pos, 8)), self.addr_of(_u(body, pos + 8, 8))
                if heap is not None and names is not None:  # dense storage
                    fheap = _FractalHeap(self, heap)
                    for rec in _btree2_records(self, names):
                        name, link = self.link(fheap.get(rec[4:]))
                        out[name] = link
        self._links[addr] = out
        return out

    def link(self, body: bytes):
        """A link message → (name, link)."""
        flags, pos = body[1], 2
        ltype = 0
        if flags & 0x08:
            ltype, pos = body[pos], pos + 1
        pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = _u(body, pos, width)
        pos += width
        name = body[pos:pos + n].decode("utf-8")
        pos += n
        if ltype == 0:
            return name, ("hard", self.addr_of(_u(body, pos, 8)))
        if ltype == 1:
            return name, ("soft", body[pos + 2:pos + 2 + _u(body, pos, 2)].decode("utf-8"))
        return name, ("external" if ltype == 64 else f"user-defined (type {ltype})", None)

    def symbol_table(self, btree: int, heap: int) -> dict:
        """name → link of a symbol-table group, from its B-tree and local heap."""
        self.check(heap, b"HEAP")
        heap_data = self.addr(heap + 24)
        d = self.data

        def heap_str(offset):
            start = heap_data + offset
            return d[start:d.find(b"\0", start)].decode("utf-8")

        links = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop()
            self.check(node, b"TREE")
            for i in range(self.u(node + 6, 2)):
                child = self.addr(node + 24 + 8 + 16 * i)
                if d[node + 5] > 0:  # an inner node: its children are nodes
                    nodes.append(child)
                    continue
                self.check(child, b"SNOD")
                for k in range(self.u(child + 6, 2)):
                    e = child + 8 + _ENTRY * k
                    name = heap_str(self.u(e, 8))
                    if self.u(e + 16, 4) == 2:  # a soft link, its value in the heap
                        links[name] = ("soft", heap_str(self.u(e + 24, 4)))
                    else:
                        links[name] = ("hard", self.addr(e + 8))
        return links

    def lookup(self, group: int, path: str, hops: int = 0):
        """The address of the object at ``path`` from the group at
        ``group`` (from the root when absolute), soft links followed; None
        when a link on the way is missing."""
        addr = self.root if path.startswith("/") else group
        for part in (p for p in path.split("/") if p and p != "."):
            link = self.links(addr).get(part)
            if link is None:
                return None
            kind, target = link
            if kind == "soft":
                if hops >= 16:
                    raise ValueError(f"{self.name}: soft links nest deeper than 16")
                target = self.lookup(addr, target, hops + 1)
                if target is None:
                    return None
            elif kind != "hard":
                raise ValueError(f"{self.name}: {kind} link {part!r} is not supported")
            addr = target
        return addr

    def walk(self, addr: int, prefix: str, out: dict, seen: set):
        """Every dataset of a supported type under the group at ``addr``,
        reached by hard links, each object once (as ``h5py``'s ``visit``)."""
        for name, (kind, target) in self.links(addr).items():
            if kind != "hard" or target in seen:
                continue
            seen.add(target)
            path = prefix + name
            if any(t == _LAYOUT for t, _ in self.header(target)):
                try:
                    out[path] = self.dataset(target)
                except UnsupportedType:
                    pass
            else:
                self.walk(target, path + "/", out, seen)

    # -- datasets ----------------------------------------------------------

    def dataset(self, addr: int) -> np.ndarray:
        msgs = dict(reversed(self.header(addr)))  # the first message of each type
        if _LAYOUT not in msgs:
            raise ValueError(f"{self.name}: the object at {addr} is not a dataset")
        shape, maxshape = _dataspace(msgs[_DATASPACE])
        dtype = _datatype(msgs[_DATATYPE])
        fill = _fill_value(msgs.get(_FILL), msgs.get(_FILL_OLD), dtype)
        kind, where = self.layout(msgs[_LAYOUT], shape, maxshape, dtype)
        count = int(np.prod(shape, dtype=np.int64))
        if kind == "chunked":
            filters = _filters(msgs[_FILTERS]) if _FILTERS in msgs else []
            return _native(self.chunked(shape, dtype, fill, filters, *where))
        if kind == "compact":
            raw = where
        elif where is None:  # contiguous, never written
            return _native(np.full(shape, fill, dtype))
        else:
            raw = self.data[where:where + count * dtype.itemsize]
        return _native(np.frombuffer(raw, dtype, count=count).reshape(shape).copy())

    def layout(self, lay: bytes, shape, maxshape, dtype):
        """A data layout message (versions 1–4) → ("compact", raw bytes),
        ("contiguous", address or None) or ("chunked", (chunk dims,
        records)); a record is (chunk coordinates in chunks, address,
        stored bytes, filter mask)."""
        version = lay[0]
        if version in (1, 2):
            ndims, cls = lay[1], lay[2]
            pos = 8 if cls == 0 else 16
            dims = [_u(lay, pos + 4 * i, 4) for i in range(ndims)]
            pos += 4 * ndims
            if cls == 0:
                return "compact", lay[pos + 4:pos + 4 + _u(lay, pos, 4)]
            if cls == 1:
                return "contiguous", self.addr_of(_u(lay, 8, 8))
            return "chunked", (dims[:-1], self.btree1_chunks(self.addr_of(_u(lay, 8, 8)),
                                                             dims))
        if version not in (3, 4):
            raise ValueError(f"{self.name}: data layout message version {version}")
        cls = lay[1]
        if cls == 0:
            return "compact", lay[4:4 + _u(lay, 2, 2)]
        if cls == 1:
            return "contiguous", self.addr_of(_u(lay, 2, 8))
        if cls != 2:
            raise ValueError(f"{self.name}: data layout class {cls} (virtual datasets are "
                             "not supported)")
        if version == 3:
            dims = [_u(lay, 11 + 4 * i, 4) for i in range(lay[2])]
            return "chunked", (dims[:-1], self.btree1_chunks(self.addr_of(_u(lay, 3, 8)),
                                                             dims))
        flags, ndims, width = lay[2], lay[3], lay[4]
        chunk = [_u(lay, 5 + width * i, width) for i in range(ndims)][:-1]
        pos = 5 + width * ndims
        index = lay[pos]
        pos += 1
        nbytes = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        grid = [-(-m // c) if m != UNDEF else None for m, c in zip(maxshape, chunk)]
        if index == 1:  # a single chunk
            size, mask = nbytes, 0
            if flags & 2:
                size, mask = _u(lay, pos, 8), _u(lay, pos + 8, 4)
                pos += 12
            addr = self.addr_of(_u(lay, pos, 8))
            records = [] if addr is None else [((0,) * len(chunk), addr, size, mask)]
        elif index == 2:  # implicit: every chunk in place, unfiltered
            base = self.addr_of(_u(lay, pos, 8))
            records = [] if base is None else [
                (c, base + int(np.ravel_multi_index(c, grid)) * nbytes, nbytes, 0)
                for c in np.ndindex(*[-(-n // k) for n, k in zip(shape, chunk)])]
        elif index == 3:
            records = self.fixed_array(self.addr_of(_u(lay, pos + 1, 8)), grid, nbytes)
        elif index == 4:
            records = self.extensible_array(self.addr_of(_u(lay, pos + 5, 8)), grid, nbytes)
        elif index == 5:
            records = self.btree2_chunks(self.addr_of(_u(lay, pos + 6, 8)), len(chunk),
                                         nbytes)
        else:
            raise ValueError(f"{self.name}: chunk index type {index}")
        if flags & 1:  # partial edge chunks are stored unfiltered: a mask of all ones
            records = [(c, a, s, 0xFFFFFFFF if any((i + 1) * k > n for i, k, n in zip(
                c, chunk, shape)) else m) for c, a, s, m in records]
        return "chunked", (chunk, records)

    def btree1_chunks(self, addr, dims):
        """The chunks of a version 1 B-tree of raw data chunks (type 1)."""
        if addr is None:
            return []
        chunk, rank = dims[:-1], len(dims)
        key = 8 + 8 * rank
        out, nodes = [], [addr]
        while nodes:
            node = nodes.pop()
            self.check(node, b"TREE")
            level = self.data[node + 5]
            for i in range(self.u(node + 6, 2)):
                k = node + 24 + i * (key + 8)
                child = self.addr(k + key)
                if level > 0:
                    nodes.append(child)
                    continue
                offsets = [self.u(k + 8 + 8 * j, 8) for j in range(rank - 1)]
                out.append((tuple(o // c for o, c in zip(offsets, chunk)), child,
                            self.u(k, 4), self.u(k + 4, 4)))
        return out

    def _element(self, b: bytes, pos: int, esize: int, nbytes: int):
        """A chunk index element → (address, stored bytes, filter mask):
        an address, plus (size, mask) when the chunks are filtered."""
        addr = self.addr_of(_u(b, pos, 8))
        if esize == 8:
            return addr, nbytes, 0
        return addr, _u(b, pos + 8, esize - 12), _u(b, pos + esize - 4, 4)

    def fixed_array(self, addr, grid, nbytes):
        if addr is None:
            return []
        self.check(addr, b"FAHD")
        d = self.data
        esize, page_bits, n = d[addr + 6], d[addr + 7], self.u(addr + 8, 8)
        block = self.addr(addr + 16)
        if block is None:
            return []
        self.check(block, b"FADB")
        page = 1 << page_bits
        out = []

        def take(raw, first, count):
            for j in range(count):
                a, size, mask = self._element(raw, j * esize, esize, nbytes)
                if a is not None:
                    out.append((np.unravel_index(first + j, grid), a, size, mask))

        if n <= page:
            take(d[block + 14:block + 14 + n * esize], 0, n)
            return out
        npages = -(-n // page)
        bitmap = d[block + 14:block + 14 + (npages + 7) // 8]
        start = block + 14 + len(bitmap) + 4
        for p in range(npages):
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                at = start + p * (page * esize + 4)
                count = min(page, n - p * page)
                take(d[at:at + count * esize], p * page, count)
        return out

    def extensible_array(self, addr, grid, nbytes):
        """The chunks of an extensible array index (one unlimited
        dimension, moved first when it is not)."""
        if addr is None:
            return []
        self.check(addr, b"EAHD")
        d = self.data
        esize, max_bits, idx_elmts, dblk_min, sblk_min, page_bits = d[addr + 6:addr + 12]
        n_set = self.u(addr + 44, 8)
        iblock = self.addr(addr + 60)
        if iblock is None:
            return []
        unlim = grid.index(None)
        order = [unlim] + [i for i in range(len(grid)) if i != unlim]
        swizzled = [1] + [grid[i] for i in order[1:]]
        off_size = (max_bits + 7) // 8
        page = 1 << page_bits
        nsblks = 1 + max_bits - _log2(dblk_min)
        info, start = [], 0
        for u in range(nsblks):
            ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
            info.append((ndblks, nelmts, start))
            start += ndblks * nelmts
        out = []

        def take(raw, first, count):
            for j in range(min(count, n_set - first)):
                a, size, mask = self._element(raw, j * esize, esize, nbytes)
                if a is not None:
                    sw = np.unravel_index(first + j, [max(n_set, 1)] + swizzled[1:])
                    coords = [0] * len(grid)
                    for axis, c in zip(order, sw):
                        coords[axis] = int(c)
                    out.append((tuple(coords), a, size, mask))

        def data_block(block, first, nelmts, bitmap=None, bit0=0):
            if block is None or first >= n_set:
                return
            self.check(block, b"EADB")
            prefix = 14 + off_size
            if nelmts <= page:
                take(d[block + prefix:block + prefix + nelmts * esize], first, nelmts)
                return
            if bitmap is None:
                raise ValueError(f"{self.name}: paged extensible array data block in the "
                                 "index block")
            for p in range(nelmts // page):
                bit = bit0 + p
                if bitmap[bit // 8] & (0x80 >> (bit % 8)):
                    at = block + prefix + 4 + p * (page * esize + 4)
                    take(d[at:at + page * esize], first + p * page, page)

        self.check(iblock, b"EAIB")
        take(d[iblock + 14:iblock + 14 + idx_elmts * esize], 0, idx_elmts)
        in_iblock = 2 * _log2(sblk_min)
        pos = iblock + 14 + idx_elmts * esize
        for u in range(min(in_iblock, nsblks)):
            ndblks, nelmts, first = info[u]
            for j in range(ndblks):
                data_block(self.addr(pos), idx_elmts + first + j * nelmts, nelmts)
                pos += 8
        for u in range(in_iblock, nsblks):
            sblock = self.addr(pos)
            pos += 8
            ndblks, nelmts, first = info[u]
            if sblock is None or idx_elmts + first >= n_set:
                continue
            self.check(sblock, b"EASB")
            at = sblock + 14 + off_size
            npages = nelmts // page if nelmts > page else 0
            # the library sizes the page bitmap by whole bytes a data block
            # but numbers its bits across data blocks
            bitmap = d[at:at + ndblks * ((npages + 7) // 8)] if npages else None
            at += len(bitmap) if npages else 0
            for j in range(ndblks):
                data_block(self.addr(at + 8 * j), idx_elmts + first + j * nelmts, nelmts,
                           bitmap, j * npages)
        return out

    def btree2_chunks(self, addr, rank, nbytes):
        """The chunks of a version 2 B-tree index (types 10 and 11): scaled
        offsets stored in each record."""
        if addr is None:
            return []
        out = []
        for rec in _btree2_records(self, addr, kinds=(10, 11)):
            a = self.addr_of(_u(rec, 0, 8))
            if len(rec) == 8 + 8 * rank:  # type 10: unfiltered
                size, mask, pos = nbytes, 0, 8
            else:
                width = len(rec) - 12 - 8 * rank
                size, mask, pos = _u(rec, 8, width), _u(rec, 8 + width, 4), 12 + width
            out.append((tuple(_u(rec, pos + 8 * i, 8) for i in range(rank)), a, size, mask))
        return out

    def chunked(self, shape, dtype, fill, filters, chunk, records) -> np.ndarray:
        """Assemble a chunked dataset: each chunk unfiltered and copied in
        by slicing; chunks never written read as ``fill``."""
        if len(chunk) != len(shape):
            raise ValueError(f"{self.name}: chunks of rank {len(chunk)} for a dataset of "
                             f"rank {len(shape)}")
        out = np.full(shape, fill, dtype)
        nbytes = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        for coords, addr, size, mask in records:
            lo = [int(c) * k for c, k in zip(coords, chunk)]
            if any(a >= n for a, n in zip(lo, shape)):
                continue  # beyond a dataset that shrank
            raw = _unfilter(self.data[addr:addr + size], filters, mask, dtype.itemsize,
                            self.name)
            if len(raw) < nbytes:
                raise ValueError(f"{self.name}: chunk at {addr} holds {len(raw)} bytes, "
                                 f"expected {nbytes}")
            block = np.frombuffer(raw, dtype, count=nbytes // dtype.itemsize).reshape(chunk)
            hi = [min(a + k, n) for a, k, n in zip(lo, chunk, shape)]
            out[tuple(slice(a, b) for a, b in zip(lo, hi))] = block[
                tuple(slice(0, b - a) for a, b in zip(lo, hi))]
        return out


class _FractalHeap:
    """The managed objects of a fractal heap, by heap ID."""

    def __init__(self, f: _File, addr: int):
        f.check(addr, b"FRHP")
        self.f = f
        if f.u(addr + 7, 2):
            raise ValueError(f"{f.name}: fractal heaps with I/O filters are not supported")
        max_man = f.u(addr + 10, 4)
        width, start = f.u(addr + 110, 2), f.u(addr + 112, 8)
        max_direct, max_bits = f.u(addr + 120, 8), f.u(addr + 128, 2)
        root, rows = f.addr(addr + 132), f.u(addr + 140, 2)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_man))
        self.blocks = []  # (heap offset, address) of each direct block
        max_direct_rows = _log2(max_direct) - _log2(start) + 2

        def indirect(block, nrows):
            f.check(block, b"FHIB")
            pos = block + 13 + self.off_size
            for row in range(nrows):
                size = start << max(row - 1, 0)
                for _ in range(width):
                    child = f.addr(pos)
                    pos += 8
                    if child is None:
                        continue
                    if row < max_direct_rows:
                        direct(child)
                    else:
                        indirect(child, _log2(size) - _log2(start * width) + 1)

        def direct(block):
            f.check(block, b"FHDB")
            self.blocks.append((f.u(block + 13, self.off_size), block))

        if root is not None:
            (indirect(root, rows) if rows else direct(root))
        self.blocks.sort()

    def get(self, hid: bytes) -> bytes:
        kind = (hid[0] >> 4) & 3
        if kind == 2:  # tiny: the object is in the ID
            return hid[1:1 + (hid[0] & 0x0F) + 1]
        if kind != 0:
            raise ValueError(f"{self.f.name}: fractal heap objects stored as 'huge' are "
                             "not supported")
        off = _u(hid, 1, self.off_size)
        length = _u(hid, 1 + self.off_size, self.len_size)
        i = bisect.bisect_right(self.blocks, (off, UNDEF)) - 1
        boff, block = self.blocks[i]
        at = block + off - boff
        return self.f.data[at:at + length]


def _btree2_records(f: _File, addr: int, kinds=(5,)):
    """Every record of a version 2 B-tree, as bytes."""
    f.check(addr, b"BTHD")
    kind = f.data[addr + 5]
    if kind not in kinds:
        raise ValueError(f"{f.name}: version 2 B-tree of type {kind}, expected {kinds}")
    node_size, rec, depth = f.u(addr + 6, 4), f.u(addr + 10, 2), f.u(addr + 12, 2)
    root, root_n = f.addr(addr + 16), f.u(addr + 24, 2)
    max_nrec = [(node_size - 10) // rec]
    nrec_size = _enc_size(max_nrec[0])
    cum, cum_size = [max_nrec[0]], [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - 10 - ptr) // (rec + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_enc_size(cum[d]))
    out = []

    def node(at, n, d):
        f.check(at, b"BTIN" if d else b"BTLF")
        recs = [f.data[at + 6 + i * rec:at + 6 + (i + 1) * rec] for i in range(n)]
        if d == 0:
            out.extend(recs)
            return
        pos = at + 6 + n * rec
        for i in range(n + 1):
            child, child_n = f.addr(pos), f.u(pos + 8, nrec_size)
            pos += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            node(child, child_n, d - 1)
            if i < n:
                out.append(recs[i])

    if root is not None and root_n:
        node(root, root_n, depth)
    return out


def _dataspace(body: bytes):
    """→ (shape, maximum shape; UNDEF where unlimited)."""
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        pos = 4
        if body[3] == 2:
            raise UnsupportedType("HDF5: null dataspaces are not supported")
    else:
        raise ValueError(f"HDF5: dataspace message version {version}")
    shape = tuple(_u(body, pos + 8 * i, 8) for i in range(rank))
    if not flags & 1:
        return shape, shape
    return shape, tuple(_u(body, pos + 8 * (rank + i), 8) for i in range(rank))


def _datatype(body: bytes) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, _u(body, 1, 3), _u(body, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        if size in (1, 2, 4, 8) and (_u(body, 8, 2), _u(body, 10, 2)) == (0, 8 * size):
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        raise UnsupportedType(f"HDF5: integer type of {size} bytes, precision "
                              f"{_u(body, 10, 2)} at bit {_u(body, 8, 2)}")
    if cls == 1:
        layout = (body[12], body[13], body[15], _u(body, 16, 4))
        if (not bits & 0x40 and size in _IEEE and layout == _IEEE[size] and body[14] == 0
                and (_u(body, 8, 2), _u(body, 10, 2)) == (0, 8 * size)):
            return np.dtype(f"{order}f{size}")
        raise UnsupportedType(f"HDF5: non-IEEE floating-point type of {size} bytes")
    if cls == 3:
        return np.dtype(f"S{size}")
    name = _TYPE_NAMES.get(cls, f"class {cls}")
    if cls == 9 and bits & 0x0F == 1:
        name = "variable-length string"
    raise UnsupportedType(f"HDF5: datatype {name} is not supported")


def _fill_value(new, old, dtype):
    """The fill value of a dataset's storage never written (0 by default)."""
    value = b""
    if new is not None:
        if new[0] == 3:
            if new[1] & 0x20:
                value = new[6:6 + _u(new, 2, 4)]
        elif new[0] == 1 or new[3]:
            value = new[8:8 + _u(new, 4, 4)]
    elif old is not None:
        value = old[4:4 + _u(old, 0, 4)]
    if len(value) != dtype.itemsize:
        return np.zeros((), dtype)
    return np.frombuffer(value, dtype)[0]


def _filters(body: bytes):
    """A filter pipeline message → [(filter id, client data)], in the
    order the filters were applied; an unsupported filter raises."""
    version, n = body[0], body[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u(body, pos, 2)
        named = version == 1 or fid >= 256
        name_len = _u(body, pos + 2, 2) if named else 0
        pos += 4 if named else 2
        nvalues = _u(body, pos + 2, 2)
        pos += 4
        name = body[pos:pos + name_len].split(b"\0")[0].decode("ascii", "replace")
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        values = [_u(body, pos + 4 * i, 4) for i in range(nvalues)]
        pos += 4 * (nvalues + (nvalues % 2 if version == 1 else 0))
        if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
            label = _FILTER_NAMES.get(fid, name or "a plugin")
            raise ValueError(f"HDF5: filter {fid} ({label}) is not supported")
        out.append((fid, values))
    return out


def _fletcher32(data: bytes) -> int:
    """The HDF5 library's Fletcher-32 of ``data`` (16-bit big-endian words,
    sums folded every 360 words, kept in 32 bits)."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n).astype(np.int64)
    full = n // 360
    weights = np.arange(360, 0, -1, dtype=np.int64)
    blocks = words[:full * 360].reshape(full, 360)
    sums = list(zip(blocks.sum(1).tolist(), (blocks @ weights).tolist(), [360] * full))
    if n % 360:
        tail = words[full * 360:]
        sums.append((int(tail.sum()), int(tail @ weights[360 - len(tail):]), len(tail)))
    s1 = s2 = 0
    for a, b, t in sums:
        s2 = (s2 + t * s1 + b) & 0xFFFFFFFF
        s1 = (s1 + a) & 0xFFFFFFFF
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _unfilter(raw: bytes, filters, mask: int, itemsize: int, name) -> bytes:
    """Undo the pipeline in reverse order, skipping the filters ``mask``
    marks as not applied to this chunk."""
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid, values = filters[i]
        if fid == _DEFLATE:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(f"{name}: HDF5 deflate chunk does not decompress: {e}") \
                    from None
        elif fid == _SHUFFLE:
            size = values[0] if values else itemsize
            n = len(raw) // size
            if size > 1 and n:
                raw = (np.frombuffer(raw, np.uint8, count=n * size).reshape(size, n).T
                       .tobytes() + raw[n * size:])
        else:
            stored, sums = _u(raw, len(raw) - 4, 4), _fletcher32(raw[:-4])
            swapped = ((sums & 0x00FF00FF) << 8) | ((sums >> 8) & 0x00FF00FF)
            if stored not in (sums, swapped):
                raise ValueError(f"{name}: HDF5 fletcher32 checksum mismatch: the chunk "
                                 "is corrupt")
            raw = raw[:-4]
    return raw


def _native(array: np.ndarray) -> np.ndarray:
    """Big-endian numbers in native order."""
    if array.dtype.byteorder == ">":
        return array.astype(array.dtype.newbyteorder("="))
    return array


def _open(path):
    f = open(path, "rb")
    try:
        return f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except BaseException:
        f.close()
        raise


def read_datasets(path, names=None) -> Dict[str, np.ndarray]:
    """The datasets of an HDF5 file → {"group/…/name": array}: those at
    ``names`` (a missing one raises ``KeyError``; soft links on the way are
    followed), or, when ``names`` is None, every dataset of a supported
    type reached by hard links, each object once (as ``h5py``'s ``visit``).
    Only the groups on the paths to ``names`` are opened, so a format this
    module does not cover elsewhere in the file is no obstacle."""
    f, data = _open(path)
    try:
        fh = _File(data, str(path))
        out: Dict[str, np.ndarray] = {}
        if names is None:
            fh.walk(fh.root, "", out, {fh.root})
            return out
        missing = []
        for name in names:
            key = name.strip("/")
            addr = fh.lookup(fh.root, key)
            if addr is None:
                missing.append(key)
            else:
                out[key] = fh.dataset(addr)
        if missing:
            raise KeyError(f"{path}: no dataset {', '.join(missing)}")
        return out
    finally:
        data.close()
        f.close()


def dataset_chunks(path, name):
    """The chunks of the chunked dataset ``name``: [(first element's index
    per dimension, file offset, stored bytes, filter mask)], in no set
    order; chunks never written are absent."""
    f, data = _open(path)
    try:
        fh = _File(data, str(path))
        addr = fh.lookup(fh.root, name.strip("/"))
        if addr is None:
            raise KeyError(f"{path}: no dataset {name}")
        msgs = dict(reversed(fh.header(addr)))
        shape, maxshape = _dataspace(msgs[_DATASPACE])
        kind, where = fh.layout(msgs[_LAYOUT], shape, maxshape, _datatype(msgs[_DATATYPE]))
        if kind != "chunked":
            raise ValueError(f"{path}: {name} is {kind}, not chunked")
        chunk, records = where
        return [(tuple(int(c) * k for c, k in zip(coords, chunk)), a, size, mask)
                for coords, a, size, mask in records]
    finally:
        data.close()
        f.close()


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

"""A narrow HDF5 reader and writer in pure numpy, for the chain files.

The card's machine has no h5py, so the port carries the subset of HDF5 that
io/chain.py needs, as io/fits.py carries a subset of FITS. It reads and
writes files that h5py and the HDF5 library read and write:

  * superblock version 0, 8-byte offsets and lengths;
  * groups in the original format: version-1 object headers with a symbol
    table message, a version-1 B-tree of symbol-table nodes, a local heap
    for the member names;
  * datasets with contiguous storage: little- or big-endian integers and
    floats of 1, 2, 4 or 8 bytes (written little-endian), scalar or of any
    rank, empty ones too;
  * attributes on groups and datasets: integer and float scalars and
    arrays, fixed-length strings, and variable-length strings (kept in a
    global heap collection, as h5py writes a Python str).

That is what the HDF5 library writes by default (h5py's libver "earliest"),
and what the JAX package's ChainFile writes through h5py. Anything else
(compact, chunked or filtered datasets, the newer object-header and link
formats, compound types) raises NotImplementedError.

How a file is updated: the whole metadata tree is held in memory; new
dataset data are appended at the end of the file, and each flush() appends
a fresh copy of the metadata (object headers, B-trees, symbol-table nodes,
local heaps, one global heap) and rewrites the superblock to point at it.
The data of earlier datasets never move. The older metadata stays in the
file unreferenced, as the HDF5 library leaves freed space without a repack:
a few kilobytes per flush. Every node is written at the full size the
library's own K values give it (group leaf K 4, internal K 16), so the HDF5
library can open such a file and add to it in place.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 4            # symbols per symbol-table node: 2 K
_NODE_K = 16           # children per B-tree node: 2 K
_ENTRY = 40            # bytes of a symbol-table entry
_SNOD_SIZE = 8 + 2 * _LEAF_K * _ENTRY
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
_GCOL_MIN = 4096


class Dataset:
    """A dataset's shape, dtype and the file address of its contiguous bytes
    (None for none)."""

    def __init__(self, dtype, shape, addr=None, attrs=None):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.addr = addr
        self.attrs = dict(attrs or {})

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


class Group:
    """A group: its members (Group or Dataset by name) and attributes."""

    def __init__(self, attrs=None):
        self.members: dict = {}
        self.attrs = dict(attrs or {})


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, f):
        self.f = f

    def read(self, addr: int, n: int) -> bytes:
        self.f.seek(addr)
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError(f"HDF5: short read of {n} bytes at {addr}")
        return b

    def superblock(self) -> int:
        b = self.read(0, 96)
        if b[:8] != _SIG:
            raise ValueError("not an HDF5 file (no signature at offset 0)")
        if b[8] != 0:
            raise NotImplementedError(f"HDF5 superblock version {b[8]}")
        if b[13] != 8 or b[14] != 8:
            raise NotImplementedError("HDF5 offsets/lengths other than 8")
        return struct.unpack_from("<Q", b, 56 + 8)[0]   # root header

    def messages(self, addr: int):
        """[(type, flags, body bytes)] of the object header at addr."""
        pre = self.read(addr, 16)
        if pre[:4] == b"OHDR":
            raise NotImplementedError("HDF5 version-2 object headers")
        if pre[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {pre[0]}")
        nmsg, _, size = struct.unpack_from("<HII", pre, 2)
        chunks = [(addr + 16, size)]
        out = []
        while chunks and len(out) < nmsg:
            start, size = chunks.pop(0)
            buf = self.read(start, size)
            p = 0
            while p + 8 <= size and len(out) < nmsg:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
                body = buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == 0x10:              # continuation
                    chunks.append(struct.unpack_from("<QQ", body, 0))
                if flags & 0x02:
                    raise NotImplementedError("HDF5 shared messages")
                out.append((mtype, flags, body))
        return out

    def heap_data(self, addr: int) -> bytes:
        b = self.read(addr, 32)
        if b[:4] != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {addr}")
        size, _, data_addr = struct.unpack_from("<QQQ", b, 8)
        return self.read(data_addr, size)

    def btree_entries(self, addr: int, heap: bytes):
        """(name, header address) of every symbol under the group B-tree
        node at addr."""
        b = self.read(addr, 24)
        if b[:4] != b"TREE":
            raise ValueError(f"HDF5: no B-tree node at {addr}")
        ntype, level, used = struct.unpack_from("<BBH", b, 4)
        if ntype != 0:
            raise NotImplementedError("HDF5 chunk B-trees")
        body = self.read(addr + 24, (2 * used + 1) * 8)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                    for i in range(used)]
        out = []
        for c in children:
            if level > 0:
                out += self.btree_entries(c, heap)
                continue
            s = self.read(c, 8)
            if s[:4] != b"SNOD":
                raise ValueError(f"HDF5: no symbol-table node at {c}")
            nsym = struct.unpack_from("<H", s, 6)[0]
            ents = self.read(c + 8, nsym * _ENTRY)
            for i in range(nsym):
                off, hdr = struct.unpack_from("<QQ", ents, i * _ENTRY)
                name = heap[off:heap.index(b"\0", off)].decode("utf-8")
                out.append((name, hdr))
        return out

    def gheap_object(self, addr: int, index: int) -> bytes:
        b = self.read(addr, 16)
        if b[:4] != b"GCOL":
            raise ValueError(f"HDF5: no global heap at {addr}")
        size = struct.unpack_from("<Q", b, 8)[0]
        buf = self.read(addr, size)
        p = 16
        while p + 16 <= size:
            idx, _, osize = struct.unpack_from("<HH4xQ", buf, p)
            if idx == 0:
                break
            if idx == index:
                return buf[p + 16:p + 16 + osize]
            p += 16 + _pad8(osize)
        raise ValueError(f"HDF5: global heap object {index} not found")

    def obj(self, addr: int):
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        attrs = {}
        for mtype, _, body in msgs:
            if mtype == 0x0C:
                name, value = self.attribute(body)
                attrs[name] = value
        if 0x11 in types:
            body = next(b for t, _, b in msgs if t == 0x11)
            btree, heap_addr = struct.unpack_from("<QQ", body, 0)
            g = Group(attrs)
            heap = self.heap_data(heap_addr)
            for name, hdr in self.btree_entries(btree, heap):
                g.members[name] = self.obj(hdr)
            return g
        if 0x02 in types or 0x06 in types:
            raise NotImplementedError("HDF5 link-message groups")
        if 0x08 not in types:
            # a group with nothing in it written without a symbol table
            return Group(attrs)
        dt = shape = None
        for mtype, _, body in msgs:
            if mtype == 0x01:
                shape = _parse_dataspace(body)
            elif mtype == 0x03:
                dt, _ = _parse_datatype(body)
            elif mtype == 0x0B:
                raise NotImplementedError("HDF5 filtered datasets")
        if isinstance(dt, str):
            raise NotImplementedError("HDF5 variable-length datasets")
        ds = Dataset(dt, shape, attrs=attrs)
        body = next(b for t, _, b in msgs if t == 0x08)
        if body[0] != 3:
            raise NotImplementedError(f"HDF5 layout version {body[0]}")
        if body[1] != 1:
            raise NotImplementedError("HDF5 compact or chunked datasets")
        addr_, _ = struct.unpack_from("<QQ", body, 2)
        ds.addr = None if addr_ == UNDEF else addr_
        return ds

    def attribute(self, body: bytes):
        ver = body[0]
        nlen, tlen, slen = struct.unpack_from("<HHH", body, 2)
        p = 8 if ver == 1 else 8 if ver == 2 else 9
        pad = _pad8 if ver == 1 else (lambda n: n)
        name = body[p:p + nlen].split(b"\0", 1)[0].decode("utf-8")
        p += pad(nlen)
        dt, _ = _parse_datatype(body[p:p + tlen])
        p += pad(tlen)
        shape = _parse_dataspace(body[p:p + slen])
        p += pad(slen)
        n = int(np.prod(shape, dtype=np.int64))
        if dt == "vlen":
            vals = []
            for i in range(n):
                ln, gaddr, idx = struct.unpack_from("<IQI", body, p + 16 * i)
                raw = self.gheap_object(gaddr, idx)[:ln] if ln else b""
                vals.append(raw.decode("utf-8"))
            return name, (vals[0] if shape == () else
                          np.array(vals, object).reshape(shape))
        arr = np.frombuffer(body[p:p + n * dt.itemsize], dt).reshape(shape)
        return name, (arr[()] if shape == () else arr.copy())


def _parse_dataspace(b: bytes) -> tuple:
    ver, rank = b[0], b[1]
    if ver == 1:
        p = 8
    elif ver == 2:
        if b[3] == 2:            # null dataspace
            return (0,)
        p = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace version {ver}")
    return tuple(struct.unpack_from(f"<{rank}Q", b, p)) if rank else ()


def _parse_datatype(b: bytes):
    """(numpy dtype, or "vlen" for a variable-length string; size)."""
    cls = b[0] & 0x0F
    f0 = b[1]
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if f0 & 0x01 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if f0 & 0x08 else 'u'}{size}"), size
    if cls == 1:
        return np.dtype(f"{order}f{size}"), size
    if cls == 3:
        return np.dtype(f"S{size}"), size
    if cls == 9 and (f0 & 0x0F) == 1:
        return "vlen", size
    if cls == 8:                 # enum (h5py's bool): its base integer type
        return _parse_datatype(b[8:])[0], size
    raise NotImplementedError(f"HDF5 datatype class {cls}")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _datatype(dt) -> bytes:
    dt = np.dtype(dt)
    if dt.kind in "iu":
        f0 = (1 if dt.byteorder == ">" else 0) | (0x08 if dt.kind == "i"
                                                  else 0)
        return struct.pack("<B3BIHH", 0x10, f0, 0, 0, dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f":
        spec = {4: (31, 32, 23, 8, 23, 127), 8: (63, 64, 52, 11, 52, 1023),
                2: (15, 16, 10, 5, 10, 15)}[dt.itemsize]
        f0 = 0x20 | (1 if dt.byteorder == ">" else 0)
        sign, prec, eloc, esz, msz, bias = spec
        return struct.pack("<B3BIHHBBBBI", 0x11, f0, sign, 0, dt.itemsize,
                           0, prec, eloc, esz, 0, msz, bias)
    if dt.kind == "S":
        return struct.pack("<B3BI", 0x13, 0x00, 0, 0, dt.itemsize)
    raise NotImplementedError(f"HDF5 writer: dtype {dt}")


def _vlen_str_type() -> bytes:
    # variable-length UTF-8 string (class 9, type 1, null-terminated), base
    # type an unsigned byte: what h5py writes for a Python str
    base = struct.pack("<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8)
    return struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + base


def _dataspace(shape) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", s) for s in shape)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _header(msgs: list) -> bytes:
    body = b"".join(msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _attr_value(v):
    """(datatype bytes, shape, raw bytes or list of str) of a value."""
    if isinstance(v, str):
        return _vlen_str_type(), (), [v]
    if isinstance(v, bytes):
        a = np.array(v)
        return _datatype(a.dtype), (), a.tobytes()
    a = np.asarray(v)
    if a.dtype == bool:
        a = a.astype(np.int8)
    if a.dtype.kind in "OU":
        vals = [str(x) for x in a.reshape(-1)]
        return _vlen_str_type(), a.shape, vals
    a = np.asarray(a, a.dtype.newbyteorder("<"), order="C")
    return _datatype(a.dtype), a.shape, a.tobytes()


class File:
    """An HDF5 file as a Group tree (`root`), opened with mode "r" (read),
    "a" (read and append; made when missing) or "w" (made anew)."""

    def __init__(self, path: str, mode: str = "a"):
        if mode not in ("r", "a", "w"):
            raise ValueError(f"mode {mode!r}")
        self.path = path
        self.mode = mode
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if mode == "r" and not exists:
            raise FileNotFoundError(path)
        if mode == "w" or not exists:
            self._f = open(path, "w+b")
            self.root = Group()
            self._f.write(b"\0" * 96)
            self._eof = 96
            self._dirty = True
        else:
            self._f = open(path, "rb" if mode == "r" else "r+b")
            r = _Reader(self._f)
            self.root = r.obj(r.superblock())
            self._f.seek(0, os.SEEK_END)
            self._eof = self._f.tell()
            self._dirty = False
        self._reader = _Reader(self._f)

    # -- tree ---------------------------------------------------------------
    def get(self, path: str):
        node = self.root
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node.members:
                return None
            node = node.members[part]
        return node

    def require_group(self, path: str) -> Group:
        node = self.root
        for part in [p for p in path.split("/") if p]:
            nxt = node.members.get(part)
            if nxt is None:
                nxt = node.members[part] = Group()
                self._dirty = True
            if not isinstance(nxt, Group):
                raise ValueError(f"{path}: {part} is a dataset")
            node = nxt
        return node

    def write_dataset(self, group: Group, name: str, data) -> Dataset:
        """Append `data`'s bytes (little-endian, contiguous) and make it
        group/name, replacing a member of that name."""
        self._writable()
        a = np.asarray(data)
        if a.dtype == bool:
            a = a.astype(np.int8)
        if a.dtype.kind not in "iuf":
            raise NotImplementedError(f"HDF5 writer: dataset dtype {a.dtype}")
        a = np.asarray(a, a.dtype.newbyteorder("<"), order="C")
        ds = Dataset(a.dtype, a.shape)
        if a.nbytes:
            ds.addr = self._append(a.tobytes())
        group.members[name] = ds
        self._dirty = True
        return ds

    def read_dataset(self, ds: Dataset) -> np.ndarray:
        if ds.addr is None or ds.nbytes == 0:
            return np.zeros(ds.shape, ds.dtype)
        raw = self._reader.read(ds.addr, ds.nbytes)
        return np.frombuffer(raw, ds.dtype).reshape(ds.shape).copy()

    # -- output -------------------------------------------------------------
    def modified(self):
        """Mark the tree changed (after setting attributes directly), so
        that the next flush writes it."""
        self._writable()
        self._dirty = True

    def _writable(self):
        if self.mode == "r":
            raise ValueError(f"{self.path} is open read-only")

    def _append(self, raw: bytes) -> int:
        addr = _pad8(self._eof)
        self._f.seek(self._eof)
        self._f.write(b"\0" * (addr - self._eof) + raw)
        self._eof = addr + len(raw)
        return addr

    def _reserve(self, n: int) -> int:
        return self._append(b"\0" * n)

    def _poke(self, addr: int, raw: bytes):
        self._f.seek(addr)
        self._f.write(raw)

    def _attr_messages(self, attrs: dict, gheap: list) -> list:
        out = []
        for name, v in attrs.items():
            dtb, shape, raw = _attr_value(v)
            if isinstance(raw, list):          # vlen strings: heap objects
                refs = []
                for s in raw:
                    gheap.append(s.encode("utf-8"))
                    refs.append((len(gheap[-1]), len(gheap)))
                raw = b"".join(struct.pack("<IQI", n, 0, i)
                               for n, i in refs)
                # the heap's address is patched in by flush
                raw = _GheapRef(raw)
            nm = name.encode("utf-8") + b"\0"
            sp = _dataspace(shape)
            pre = struct.pack("<BBHHH", 1, 0, len(nm), len(dtb), len(sp))
            out.append((pre, nm, dtb, sp, raw))
        return out

    def _write_obj(self, node, gheap: list, pending: list) -> int:
        """Write node (post order); returns its object header address."""
        attrs = self._attr_messages(node.attrs, gheap)
        if isinstance(node, Dataset):
            msgs = [_message(0x01, _dataspace(node.shape)),
                    _message(0x03, _datatype(node.dtype)),
                    _message(0x05, struct.pack("<BBBB", 2, 2, 2, 0)),
                    _message(0x08, struct.pack(
                        "<BBQQ", 3, 1,
                        UNDEF if node.addr is None else node.addr,
                        node.nbytes))]
        else:
            names = sorted(node.members)
            addrs = [self._write_obj(node.members[n], gheap, pending)
                     for n in names]
            btree, heap = self._write_stab(names, addrs)
            msgs = [_message(0x11, struct.pack("<QQ", btree, heap))]
        return self._write_header(msgs, attrs, pending)

    def _write_header(self, msgs, attrs, pending) -> int:
        amsgs = []
        for pre, nm, dtb, sp, raw in attrs:
            pad = lambda x: x + b"\0" * (_pad8(len(x)) - len(x))
            head = pre + pad(nm) + pad(dtb) + pad(sp)
            amsgs.append((head, raw))
        blobs = list(msgs)
        for head, raw in amsgs:
            data = raw.raw if isinstance(raw, _GheapRef) else raw
            blobs.append(_message(0x0C, head + data))
        addr = self._append(_header(blobs))
        # vlen references: where in this header each one's address goes
        p = addr + 16 + sum(len(m) for m in msgs)
        for (head, raw), blob in zip(amsgs, blobs[len(msgs):]):
            if isinstance(raw, _GheapRef):
                start = p + 8 + len(head)
                pending += [start + 16 * k + 4
                            for k in range(len(raw.raw) // 16)]
            p += len(blob)
        return addr

    def _write_stab(self, names: list, addrs: list):
        """A group's local heap, symbol-table nodes and B-tree; returns
        (B-tree address, heap address)."""
        data = bytearray(b"\0" * 8)               # "" at offset 0
        offs = []
        for n in names:
            offs.append(len(data))
            raw = n.encode("utf-8") + b"\0"
            data += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        free = len(data)                          # one free block, as the
        data += struct.pack("<QQ", 1, 16)         # library writes its heaps
        data_addr = self._append(bytes(data))
        heap = self._append(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(data), free, data_addr))
        # leaves: symbol-table nodes of up to 2 K entries
        per = 2 * _LEAF_K
        leaves = []
        if not names:
            node = b"TREE" + struct.pack("<BBHQQQ", 0, 0, 0, UNDEF, UNDEF, 0)
            node += b"\0" * (_TREE_SIZE - len(node))
            return self._append(node), heap
        for i in range(0, len(names), per):
            ents = b""
            chunk = list(zip(offs, addrs))[i:i + per]
            for off, hdr in chunk:
                ents += struct.pack("<QQII16x", off, hdr, 0, 0)
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + ents
            node += b"\0" * (_SNOD_SIZE - len(node))
            last = offs[min(i + per, len(offs)) - 1] if chunk else 0
            leaves.append((self._append(node), last))
        level, nodes = 0, leaves
        while True:
            parents = []
            for i in range(0, len(nodes), 2 * _NODE_K):
                kids = nodes[i:i + 2 * _NODE_K]
                body = struct.pack("<Q", 0)
                for addr, last in kids:
                    body += struct.pack("<QQ", addr, last)
                node = b"TREE" + struct.pack("<BBHQQ", 0, level, len(kids),
                                             UNDEF, UNDEF) + body
                node += b"\0" * (_TREE_SIZE - len(node))
                parents.append((self._append(node), kids[-1][1]))
            if len(parents) == 1:
                return parents[0][0], heap
            nodes, level = parents, level + 1

    def flush(self):
        """Write the metadata tree and point the superblock at it."""
        if self.mode == "r" or not self._dirty:
            return
        gheap, pending = [], []
        root = self._write_obj(self.root, gheap, pending)
        if gheap:
            objs = b""
            for i, raw in enumerate(gheap, start=1):
                objs += struct.pack("<HH4xQ", i, 1, len(raw)) + raw \
                    + b"\0" * (_pad8(len(raw)) - len(raw))
            size = max(_GCOL_MIN, _pad8(16 + len(objs) + 16))
            free = size - 16 - len(objs)
            col = b"GCOL" + struct.pack("<B3xQ", 1, size) + objs \
                + struct.pack("<HH4xQ", 0, 0, free)
            col += b"\0" * (size - len(col))
            gaddr = self._append(col)
            for at in pending:
                self._poke(at, struct.pack("<Q", gaddr))
        rmsgs = self._reader.messages(root)
        body = next(b for t, _, b in rmsgs if t == 0x11)
        btree, heap = struct.unpack_from("<QQ", body, 0)
        sb = _SIG + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                _LEAF_K, _NODE_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, self._eof, UNDEF)
        sb += struct.pack("<QQII", 0, root, 1, 0) + struct.pack(
            "<QQ", btree, heap)
        self._poke(0, sb)
        self._f.flush()
        self._dirty = False

    def close(self):
        if self._f.closed:
            return
        try:
            self.flush()
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _GheapRef:
    """Attribute bytes holding global-heap references whose heap address
    is filled in when the collection is written."""

    def __init__(self, raw: bytes):
        self.raw = raw

"""A NumPy reader and writer for the part of HDF5 that the checkpoints and
driver series use (``initd<ntrun>.<exp>.h5``, ``driverdata.<exp>.h5``).

Those files hold groups nested to any depth, contiguous little-endian
datasets of IEEE floats (f32, f64) and fixed-size integers (0-d ones and
ones with a zero-length dimension among them), and numeric attributes on
groups.  This module reads and writes exactly that, with ``struct`` and
NumPy, so the port reads and writes them where h5py is not installed.

The structures are those of the HDF5 file format specification, version
2.0 (the "original" format, which h5py writes by default):

- superblock version 0, 8-byte offsets and lengths;
- version 1 object headers, their continuation and NIL messages;
- symbol-table groups: a local heap of member names, a v1 B-tree of type 0
  (of any depth) whose leaves are symbol-table nodes (``SNOD``), the
  members of a node and the keys of a B-tree sorted by the bytes of the
  names (the library finds a member by binary search);
- dataspace messages of version 1 and 2, datatype messages of the fixed-
  point and floating-point classes, layout messages of version 3 with a
  contiguous layout (a dataset with no element has no storage: its
  address is the undefined address), version 1 attribute messages.

`read` raises ValueError, naming what it met, on anything else (chunked
or compact layouts, filters, new-style groups, strings, compound or
big-endian types, other superblock versions).  `write` writes only these
structures, so one parser covers h5py's files and the port's.  It streams
each array to the file after its children, so no more than the array in
hand is held beside the tree; the root's address goes into the superblock
at the end.

    tree = Group({"m": {"u": u}, "pres": p}, attrs={"dt": 0.1})
    write(path, tree)
    back = read(path)          # a Group; back["m"]["u"], back.attrs["dt"]
"""
from __future__ import annotations

import mmap
import struct
from pathlib import Path

import numpy as np

__all__ = ["Group", "read", "write"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 4            # a symbol-table node holds 2 x 4 members
_NODE_K = 16           # a B-tree node holds 2 x 16 children
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
_HEAP_FREE_NULL = 1    # the library's "no free block" in a local heap

# message types
_NIL, _DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x0, 0x1, 0x3, 0x5, 0x8
_ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0xC, 0x10, 0x11
# messages that say nothing of the data read here: the old fill value, the
# fill value, comments and modification times
_IGNORED = {0x4, 0x5, 0xD, 0xE, 0x12}
_UNSUPPORTED = {
    0x2: "a link info message (new-style group)",
    0x6: "a link message (new-style group)",
    0x7: "external data files",
    0xA: "a group info message (new-style group)",
    0xB: "a filter pipeline (compressed or filtered data)",
    0x15: "an attribute info message (dense attribute storage)",
    0x16: "an object reference count (version 2 object header)",
}
_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield",
            "opaque", "compound", "reference", "enumerated",
            "variable-length", "array")
_LAYOUTS = ("compact", "contiguous", "chunked", "virtual")
# (precision, exponent location, exponent size, mantissa location,
#  mantissa size, exponent bias, sign location) of the IEEE types
_IEEE = {4: (32, 23, 8, 0, 23, 127, 31), 8: (64, 52, 11, 0, 52, 1023, 63)}


class Group(dict):
    """An HDF5 group: its members by name (arrays or groups; a plain dict
    is a group with no attributes) and its numeric attributes, `attrs`."""

    def __init__(self, members=(), attrs=None):
        super().__init__(members)
        self.attrs = dict(attrs or {})


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def read(path: str | Path) -> Group:
    """The whole file as a `Group` of NumPy arrays (0-d datasets as 0-d
    arrays, scalar attributes as NumPy scalars)."""
    path = Path(path)
    with open(path, "rb") as fh:
        if path.stat().st_size < 96:
            raise ValueError(f"{path}: too short to be an HDF5 file")
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            return _Reader(buf, path).root()


class _Reader:
    def __init__(self, buf, path):
        self.buf, self.path = buf, path

    def fail(self, what):
        raise ValueError(f"{self.path}: {what} is not supported by "
                         f"udales_tpu_torch.io.hdf5")

    def unpack(self, fmt, off):
        try:
            return struct.unpack_from("<" + fmt, self.buf, off)
        except struct.error:
            raise ValueError(f"{self.path}: truncated at byte {off}") \
                from None

    def root(self):
        if self.buf[:8] != _SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at byte 0")
        version, = self.unpack("B", 8)
        if version != 0:
            self.fail(f"superblock version {version}")
        sizes = self.unpack("BB", 13)
        if sizes != (8, 8):
            self.fail(f"offsets and lengths of {sizes} bytes")
        base, = self.unpack("Q", 24)
        if base:
            self.fail(f"a base address of {base}")
        # the root's symbol-table entry: name offset, object header
        _, header = self.unpack("QQ", 56)
        return self.object(header, "/")

    def messages(self, header, name):
        if self.buf[header:header + 4] == b"OHDR":
            self.fail(f"a version 2 object header (new-style format, "
                      f"{name})")
        version, = self.unpack("B", header)
        if version != 1:
            self.fail(f"object header version {version} ({name})")
        size, = self.unpack("I", header + 8)
        blocks, out = [(header + 16, size)], []
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                kind, length, flags = self.unpack("HHB", p)
                body = p + 8
                if body + length > end:
                    raise ValueError(f"{self.path}: corrupt object header "
                                     f"of {name}")
                if flags & 0x2:
                    self.fail(f"a shared message (type {kind}, {name})")
                if kind == _CONTINUATION:
                    blocks.append(self.unpack("QQ", body))
                elif kind in _UNSUPPORTED:
                    self.fail(f"{_UNSUPPORTED[kind]} ({name})")
                elif kind not in _IGNORED and kind != _NIL:
                    out.append((kind, body))
                p = body + length
        return out

    def object(self, header, name):
        msgs = self.messages(header, name)
        kinds = {k for k, _ in msgs}
        unknown = kinds - {_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE,
                           _SYMBOL_TABLE}
        if unknown:
            self.fail(f"message type {min(unknown):#x} ({name})")
        attrs = dict(self.attribute(body, name) for kind, body in msgs
                     if kind == _ATTRIBUTE)
        one = {k: body for k, body in msgs}
        if _SYMBOL_TABLE in kinds:
            return self.group(one[_SYMBOL_TABLE], name, attrs)
        if not {_DATASPACE, _DATATYPE, _LAYOUT} <= kinds:
            self.fail(f"an object that is neither a group nor a dataset "
                      f"({name})")
        return self.dataset(one, name)

    def group(self, body, name, attrs):
        btree, heap = self.unpack("QQ", body)
        if self.buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap for {name}")
        data, = self.unpack("Q", heap + 24)
        g = Group(attrs=attrs)
        for off, header in self.entries(btree, name):
            start = data + off
            member = bytes(self.buf[start:self.buf.find(b"\0", start)]
                           ).decode()
            g[member] = self.object(header, f"{name.rstrip('/')}/{member}")
        return g

    def entries(self, node, name):
        """(name offset, object header) of every member under B-tree
        `node`, in order."""
        if self.buf[node:node + 4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node for {name}")
        kind, level, used = self.unpack("BBH", node + 4)
        if kind != 0:
            self.fail(f"a B-tree of type {kind} ({name})")
        for i in range(used):
            child, = self.unpack("Q", node + 32 + 16 * i)
            if level:
                yield from self.entries(child, name)
                continue
            if self.buf[child:child + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol-table node for "
                                 f"{name}")
            n, = self.unpack("H", child + 6)
            for j in range(n):
                off, header, cache = self.unpack("QQI", child + 8 + 40 * j)
                if cache == 2:
                    self.fail(f"a soft link ({name})")
                yield off, header

    def dtype(self, p, name):
        cv, b0, b1, b2, size = self.unpack("BBBBI", p)
        cls, bits = cv & 0xF, b0 | b1 << 8 | b2 << 16
        if cls > 1:
            what = _CLASSES[cls] if cls < len(_CLASSES) else f"class {cls}"
            self.fail(f"the {what} datatype ({name})")
        if bits & 0x1 or (cls == 1 and bits & 0x40):
            self.fail(f"a big-endian datatype ({name})")
        if cls == 0:
            offset, precision = self.unpack("HH", p + 8)
            if size not in (1, 2, 4, 8) or (offset, precision) != (0,
                                                                 8 * size):
                self.fail(f"a {precision}-bit integer of {size} bytes "
                          f"({name})")
            return np.dtype(f"<{'i' if bits & 0x8 else 'u'}{size}")
        props = self.unpack("HHBBBBI", p + 8)
        if size not in _IEEE or props[0] != 0 or \
                props[1:] + (bits >> 8 & 0xFF,) != _IEEE[size]:
            self.fail(f"a non-IEEE float of {size} bytes ({name})")
        return np.dtype(f"<f{size}")

    def shape(self, p, name):
        version, rank = self.unpack("BB", p)
        if version == 1:
            dims = p + 8
        elif version == 2:
            kind, = self.unpack("B", p + 3)
            if kind == 2:
                self.fail(f"a null dataspace ({name})")
            dims = p + 4
        else:
            self.fail(f"dataspace version {version} ({name})")
        return self.unpack(f"{rank}Q", dims)

    def array(self, off, dtype, shape):
        n = int(np.prod(shape, dtype=np.int64))
        if off + n * dtype.itemsize > len(self.buf):
            raise ValueError(f"{self.path}: data past the end of the file")
        return np.frombuffer(self.buf, dtype, n, off).reshape(shape).copy()

    def dataset(self, one, name):
        dtype = self.dtype(one[_DATATYPE], name)
        shape = self.shape(one[_DATASPACE], name)
        p = one[_LAYOUT]
        version, cls = self.unpack("BB", p)
        if version != 3:
            self.fail(f"layout message version {version} ({name})")
        if cls != 1:
            what = _LAYOUTS[cls] if cls < len(_LAYOUTS) else f"class {cls}"
            self.fail(f"the {what} layout ({name})")
        off, size = self.unpack("QQ", p + 2)
        n = int(np.prod(shape, dtype=np.int64))
        if off == _UNDEF:
            if n:
                raise ValueError(f"{self.path}: {name} has no storage")
            return np.zeros(shape, dtype)
        if size != n * dtype.itemsize:
            raise ValueError(f"{self.path}: {name} holds {size} bytes for "
                             f"{shape} of {dtype}")
        return self.array(off, dtype, shape)

    def attribute(self, p, name):
        version, = self.unpack("B", p)
        if version != 1:
            self.fail(f"attribute message version {version} ({name})")
        nname, ntype, nspace = self.unpack("HHH", p + 2)
        q = p + 8
        key = bytes(self.buf[q:q + nname]).rstrip(b"\0").decode()
        q += _pad8(nname)
        dtype = self.dtype(q, f"{name} attribute {key}")
        q += _pad8(ntype)
        shape = self.shape(q, f"{name} attribute {key}")
        value = self.array(q + _pad8(nspace), dtype, shape)
        return key, value[()] if value.ndim == 0 else value


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write(path: str | Path, tree: dict) -> int:
    """Write `tree` (a `Group` or a dict: names to arrays, anything
    ``np.asarray`` takes, or to further groups) as a new file at `path`;
    returns the file's bytes."""
    with open(path, "wb") as fh:
        fh.write(bytes(96))
        header, btree, heap = _Writer(fh).group(tree, "/")
        eof = fh.tell()
        fh.seek(0)
        fh.write(_SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0,
            0, _UNDEF, eof, _UNDEF) + _entry(0, header, (btree, heap)))
    return eof


def _entry(name_off, header, stab=None):
    """A symbol-table entry; `stab` (B-tree, heap) caches a group's."""
    if stab is None:
        return struct.pack("<QQI4x16x", name_off, header, 0)
    return struct.pack("<QQI4xQQ", name_off, header, 1, *stab)


def _dtype_message(dt: np.dtype, name):
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        bits = 0x8 if dt.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        prec, eloc, esize, mloc, msize, bias, sign = _IEEE[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0,
                           dt.itemsize, 0, prec, eloc, esize, mloc, msize,
                           bias)
    raise ValueError(f"{name}: dtype {dt} is not supported by "
                     f"udales_tpu_torch.io.hdf5 (IEEE f4/f8 and integers)")


def _space_message(shape):
    return struct.pack(f"<BBB5x{2 * len(shape)}Q", 1, len(shape),
                       1 if shape else 0, *shape, *shape)


def _le(value, name):
    a = np.asarray(value)
    _dtype_message(a.dtype, name)
    return a.astype(a.dtype.newbyteorder("<"), order="C", copy=False)


class _Writer:
    def __init__(self, fh):
        self.fh = fh

    def put(self, data) -> int:
        pad = -self.fh.tell() % 8
        self.fh.write(bytes(pad))
        at = self.fh.tell()
        self.fh.write(data)
        return at

    def header(self, msgs, attrs, name) -> int:
        """A version 1 object header of `msgs` ((type, flags, body)) and
        the attribute messages of `attrs`."""
        msgs = list(msgs) + [(_ATTRIBUTE, 0, self.attribute(k, v, name))
                             for k, v in attrs.items()]
        body = b"".join(struct.pack("<HHB3x", kind, _pad8(len(data)), flags)
                        + data + bytes(_pad8(len(data)) - len(data))
                        for kind, flags, data in msgs)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                    len(body)) + body)

    @staticmethod
    def attribute(key, value, name):
        a = _le(value, f"{name} attribute {key}")
        parts = (key.encode() + b"\0", _dtype_message(a.dtype, key),
                 _space_message(a.shape))
        return struct.pack("<BxHHH", 1, *map(len, parts)) + b"".join(
            p + bytes(_pad8(len(p)) - len(p)) for p in parts) + a.tobytes()

    def object(self, value, name):
        """Write `value` (children first); its header's address and, for a
        group, its (B-tree, heap)."""
        if isinstance(value, dict):
            header, btree, heap = self.group(value, name)
            return header, (btree, heap)
        return self.dataset(value, name), None

    def dataset(self, value, name) -> int:
        a = _le(value, name)
        at = self.put(a.reshape(-1).view(np.uint8)) if a.size else _UNDEF
        # the fill value message the library writes by default (version 2;
        # allocation late, fill written if set, the default fill value)
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
        layout = struct.pack("<BBQQ", 3, 1, at, a.nbytes)
        return self.header([(_DATASPACE, 0, _space_message(a.shape)),
                            (_DATATYPE, 1, _dtype_message(a.dtype, name)),
                            (_FILL, 1, fill), (_LAYOUT, 0, layout)],
                           {}, name)

    def group(self, tree, name):
        """Write the members of `tree`, then its heap, symbol-table nodes
        and B-tree; (header, B-tree, heap)."""
        members = sorted(((k.encode(), v) for k, v in tree.items()),
                         key=lambda kv: kv[0])
        if any(b"/" in k or b"\0" in k or not k for k, _ in members):
            raise ValueError(f"{name}: member names must be non-empty and "
                             f"hold no '/' or NUL")
        entries, heap, names = [], bytearray(8), []
        for key, value in members:
            header, stab = self.object(value, f"{name.rstrip('/')}/"
                                              f"{key.decode()}")
            names.append(len(heap))
            entries.append(_entry(len(heap), header, stab))
            heap += key + bytes(_pad8(len(key) + 1) - len(key))
        data = self.put(bytes(heap))
        heap_at = self.put(b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap), _HEAP_FREE_NULL, data))
        # leaves: symbol-table nodes of up to 2K members, each with the
        # heap offset of its last (greatest) name; then B-tree levels of up
        # to 2K children until one node is left
        n = 2 * _LEAF_K
        nodes = []
        for i in range(0, len(entries), n):
            chunk = entries[i:i + n]
            snod = b"SNOD" + struct.pack("<BxH", 1, len(chunk)) + \
                b"".join(chunk)
            nodes.append((self.put(snod + bytes(_SNOD_SIZE - len(snod))),
                          names[i + len(chunk) - 1]))
        level = 0
        while True:
            upper = []
            for i in range(0, max(len(nodes), 1), 2 * _NODE_K):
                chunk = nodes[i:i + 2 * _NODE_K]
                keys = struct.pack("<Q", nodes[i - 1][1] if i else 0) + \
                    b"".join(struct.pack("<QQ", child, key)
                             for child, key in chunk)
                node = b"TREE" + struct.pack(
                    "<BBHQQ", 0, level, len(chunk), _UNDEF, _UNDEF) + keys
                upper.append((self.put(node + bytes(_TREE_SIZE - len(node))),
                              chunk[-1][1] if chunk else 0))
            nodes, level = upper, level + 1
            if len(nodes) == 1:
                break
        btree = nodes[0][0]
        attrs = getattr(tree, "attrs", {})
        header = self.header(
            [(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap_at))], attrs,
            name)
        return header, btree, heap_at

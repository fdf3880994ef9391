"""Minimal, self-contained protobuf runtime.

Provides just what the framework needs — no protoc, no google.protobuf
dependency:

  * a ``Message`` base class driven by ``Field`` descriptors,
  * Caffe-compatible **text format** (prototxt) parse / serialize,
  * **binary wire format** encode / decode (varints, fixed32/64,
    length-delimited, packed repeated) for ``Datum`` records,
    ``.caffemodel`` / ``.binaryproto`` / ``.solverstate`` files.

The reference obtains these from protobuf-java + the caffe.proto schema of
its (absent) caffe-public submodule; see SURVEY.md §2.9.  Re-implementing the
runtime keeps the rebuild dependency-free and lets the schema live as plain
Python (`caffeonspark_tpu/proto/caffe.py`).

Reference parity notes:
  * text parsing mirrors `jcaffe/Utils.java:11-27` (Get{Solver,Net}Param)
  * binary decode mirrors `LmdbRDD.scala:136-151` (Datum parse)
Unknown fields are skipped on decode (forward compatibility with real
caffemodels produced by other Caffe forks).
"""

from __future__ import annotations

import io
import struct
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Field types
# ---------------------------------------------------------------------------

DOUBLE = "double"
FLOAT = "float"
INT32 = "int32"
INT64 = "int64"
UINT32 = "uint32"
UINT64 = "uint64"
SINT32 = "sint32"
SINT64 = "sint64"
BOOL = "bool"
ENUM = "enum"
STRING = "string"
BYTES = "bytes"
MESSAGE = "message"

_VARINT_TYPES = {INT32, INT64, UINT32, UINT64, SINT32, SINT64, BOOL, ENUM}
_SCALAR_DEFAULTS = {
    DOUBLE: 0.0,
    FLOAT: 0.0,
    INT32: 0,
    INT64: 0,
    UINT32: 0,
    UINT64: 0,
    SINT32: 0,
    SINT64: 0,
    BOOL: False,
    ENUM: 0,
    STRING: "",
    BYTES: b"",
}

# wire types
_WT_VARINT = 0
_WT_FIXED64 = 1
_WT_LEN = 2
_WT_FIXED32 = 5


class Enum:
    """A named enum: Enum('Phase', TRAIN=0, TEST=1)."""

    def __init__(self, name: str, **values: int):
        self.name = name
        self.by_name: Dict[str, int] = dict(values)
        self.by_value: Dict[int, str] = {}
        for k, v in values.items():
            # first name wins for aliased values
            self.by_value.setdefault(v, k)
        for k, v in values.items():
            setattr(self, k, v)

    def value(self, name_or_val) -> int:
        if isinstance(name_or_val, int):
            return name_or_val
        if name_or_val in self.by_name:
            return self.by_name[name_or_val]
        raise ValueError(f"{self.name}: unknown enum value {name_or_val!r}")

    def name_of(self, val: int) -> str:
        return self.by_value.get(val, str(val))


class Field:
    """Descriptor for one protobuf field."""

    __slots__ = ("num", "name", "ftype", "repeated", "default", "enum",
                 "message", "packed")

    def __init__(self, num: int, name: str, ftype: str, *, repeated=False,
                 default=None, enum: Optional[Enum] = None, message=None,
                 packed=False):
        self.num = num
        self.name = name
        self.ftype = ftype
        self.repeated = repeated
        self.enum = enum
        self.message = message  # Message subclass (or callable returning it)
        self.packed = packed
        if default is None and not repeated and ftype != MESSAGE:
            default = _SCALAR_DEFAULTS[ftype]
        self.default = default

    def msg_cls(self):
        m = self.message
        # allow lazy references for recursive schemas
        if isinstance(m, str):
            raise TypeError("string message refs must be resolved at class "
                            "definition time")
        return m


class _RepeatedList(list):
    """List that notifies its owning message on first mutation, so lazily
    created sub-messages attach to their parent only when actually written
    (protobuf presence semantics: reading never creates fields)."""

    __slots__ = ("_owner",)

    def __init__(self, owner, *args):
        super().__init__(*args)
        self._owner = owner

    def _touch(self):
        self._owner._mark_modified()

    def append(self, v):
        super().append(v)
        self._touch()

    def extend(self, it):
        super().extend(it)
        self._touch()

    def insert(self, i, v):
        super().insert(i, v)
        self._touch()

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self._touch()

    def __iadd__(self, other):
        res = super().__iadd__(other)
        self._touch()
        return res


class _MessageMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: List[Field] = list(ns.get("FIELDS", ()))
        cls._fields_by_name = {f.name: f for f in fields}
        cls._fields_by_num = {f.num: f for f in fields}
        return cls


class Message(metaclass=_MessageMeta):
    """Base message. Subclasses define FIELDS = [Field(...), ...]."""

    FIELDS: List[Field] = []

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_attach_cb", None)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- attribute protocol --------------------------------------------------
    #
    # Reading an unset field NEVER creates it (protobuf presence semantics):
    # scalars return the default; sub-messages / repeated fields return a
    # lazily-attached placeholder that only materializes in the parent when
    # first *written* (so `cfg.state.phase` leaves cfg unchanged, while
    # `cfg.state.phase = TRAIN` vivifies the whole chain).

    def _mark_modified(self):
        cb = self._attach_cb
        if cb is not None:
            parent, fname = cb
            parent._values[fname] = self
            object.__setattr__(self, "_attach_cb", None)
            parent._mark_modified()

    def __getattr__(self, name):
        fields = type(self)._fields_by_name
        if name in fields:
            f = fields[name]
            vals = self._values
            if name not in vals:
                if f.repeated:
                    vals[name] = _RepeatedList(self)
                elif f.ftype == MESSAGE:
                    sub = f.msg_cls()()
                    object.__setattr__(sub, "_attach_cb", (self, name))
                    return sub
                else:
                    return f.default
            return vals[name]
        raise AttributeError(f"{type(self).__name__} has no field {name!r}")

    def __setattr__(self, name, value):
        f = type(self)._fields_by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.repeated and not isinstance(value, list):
            # numpy arrays are kept as-is for packed float/double fields
            # (materializing 60M PyFloats for a caffemodel is pathological)
            if not (f.packed and f.ftype in (FLOAT, DOUBLE)
                    and type(value).__name__ == "ndarray"):
                value = list(value)
        if f.ftype == ENUM and not f.repeated and isinstance(value, str):
            value = f.enum.value(value)
        self._values[name] = value
        self._mark_modified()

    def has(self, name: str) -> bool:
        v = self._values.get(name)
        if v is None:
            return False
        f = type(self)._fields_by_name[name]
        if f.repeated:
            return len(v) > 0
        return True

    def clear(self, name: str) -> None:
        self._values.pop(name, None)

    def copy_from(self, other: "Message") -> "Message":
        assert type(self) is type(other)
        self._values.clear()
        self.merge_binary(other.to_binary())
        return self

    def clone(self):
        c = type(self)()
        c.copy_from(self)
        return c

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.to_binary() == other.to_binary())

    def __repr__(self):
        body = self.to_text()
        if len(body) > 400:
            body = body[:400] + "…"
        return f"<{type(self).__name__}\n{body}>"

    # -- text format ---------------------------------------------------------

    def to_text(self, indent: int = 0) -> str:
        out: List[str] = []
        pad = "  " * indent
        for f in self.FIELDS:
            if not self.has(f.name):
                continue
            vals = self._values[f.name]
            if not f.repeated:
                vals = [vals]
            for v in vals:
                if f.ftype == MESSAGE:
                    out.append(f"{pad}{f.name} {{\n{v.to_text(indent + 1)}{pad}}}\n")
                elif f.ftype == ENUM:
                    out.append(f"{pad}{f.name}: {f.enum.name_of(v)}\n")
                elif f.ftype == STRING:
                    esc = (v.replace("\\", "\\\\").replace('"', '\\"')
                           .replace("\n", "\\n"))
                    out.append(f'{pad}{f.name}: "{esc}"\n')
                elif f.ftype == BYTES:
                    esc = "".join(
                        chr(b) if 0x20 <= b < 0x7F and b not in (0x22, 0x5C)
                        else f"\\{b:03o}" for b in v)
                    out.append(f'{pad}{f.name}: "{esc}"\n')
                elif f.ftype == BOOL:
                    out.append(f"{pad}{f.name}: {'true' if v else 'false'}\n")
                elif f.ftype in (FLOAT, DOUBLE):
                    # float() coercion: v may be a numpy scalar whose repr
                    # ('np.float32(x)') would not re-parse
                    out.append(f"{pad}{f.name}: {float(v)!r}\n")
                else:
                    out.append(f"{pad}{f.name}: {int(v)!r}\n")
        return "".join(out)

    @classmethod
    def from_text(cls, text: str) -> "Message":
        msg = cls()
        tok = _Tokenizer(text)
        _parse_fields(msg, tok, top_level=True)
        return msg

    # -- binary wire format --------------------------------------------------

    def to_binary(self) -> bytes:
        out: List[Any] = []
        self._encode_into(out)
        return b"".join(out)

    def write_to(self, f) -> int:
        """Write the wire encoding to the binary file `f`, a packed float
        field's array straight from its buffer (no copy: the write call
        releases the interpreter lock while it runs, so a snapshot
        written on a worker thread leaves the solver thread free);
        returns the byte count.  The bytes are `to_binary()`'s."""
        out: List[Any] = []
        n = self._encode_into(out)
        for chunk in out:
            f.write(chunk)
        return n

    def _encode_into(self, out: List[Any]) -> int:
        """Append the wire encoding to `out` as buffers: small fields as
        bytes, each packed float/double array as a memoryview of its
        data; returns the byte count.  A nested message's length prefix
        is its own count."""
        total = 0
        buf = io.BytesIO()

        def flush() -> None:
            nonlocal buf, total
            b = buf.getvalue()
            if b:
                out.append(b)
                total += len(b)
                buf = io.BytesIO()

        for f in self.FIELDS:
            if not self.has(f.name):
                continue
            vals = self._values[f.name]
            if not f.repeated:
                vals = [vals]
            if f.packed and f.repeated and f.ftype != MESSAGE:
                if f.ftype in (FLOAT, DOUBLE):
                    # numpy fast path: 60M-param caffemodels would take
                    # minutes through per-float struct.pack
                    import numpy as _np
                    arr = _np.ascontiguousarray(
                        vals, "<f4" if f.ftype == FLOAT else "<f8")
                    _write_key(buf, f.num, _WT_LEN)
                    _write_varint(buf, arr.nbytes)
                    flush()
                    out.append(memoryview(arr.reshape(-1)).cast("B"))
                    total += arr.nbytes
                else:
                    payload = io.BytesIO()
                    for v in vals:
                        _write_scalar(payload, f, v)
                    b = payload.getvalue()
                    _write_key(buf, f.num, _WT_LEN)
                    _write_varint(buf, len(b))
                    buf.write(b)
                continue
            for v in vals:
                if f.ftype == MESSAGE:
                    sub: List[Any] = []
                    n = v._encode_into(sub)
                    _write_key(buf, f.num, _WT_LEN)
                    _write_varint(buf, n)
                    flush()
                    out.extend(sub)
                    total += n
                elif f.ftype == STRING:
                    b = v.encode("utf-8")
                    _write_key(buf, f.num, _WT_LEN)
                    _write_varint(buf, len(b))
                    buf.write(b)
                elif f.ftype == BYTES:
                    _write_key(buf, f.num, _WT_LEN)
                    _write_varint(buf, len(v))
                    buf.write(v)
                elif f.ftype == FLOAT:
                    _write_key(buf, f.num, _WT_FIXED32)
                    buf.write(struct.pack("<f", v))
                elif f.ftype == DOUBLE:
                    _write_key(buf, f.num, _WT_FIXED64)
                    buf.write(struct.pack("<d", v))
                else:
                    _write_key(buf, f.num, _WT_VARINT)
                    _write_scalar(buf, f, v)
        flush()
        return total

    @classmethod
    def from_binary(cls, data: bytes) -> "Message":
        msg = cls()
        msg.merge_binary(data)
        return msg

    def merge_binary(self, data: bytes) -> "Message":
        # malformed wire data must surface as ValueError (the codec's
        # documented failure mode) — never a leaked struct.error from a
        # fixed32/fixed64 read off a truncated buffer, an IndexError
        # from a varint cut mid-byte, or an OverflowError from an
        # absurd corrupted length
        try:
            return self._merge_binary_impl(data)
        except (struct.error, IndexError, OverflowError) as e:
            raise ValueError(
                f"malformed protobuf wire data: "
                f"{type(e).__name__}: {e}") from e

    def _merge_binary_impl(self, data: bytes) -> "Message":
        view = memoryview(data)
        pos = 0
        n = len(view)
        fields = type(self)._fields_by_num
        while pos < n:
            key, pos = _read_varint(view, pos)
            fnum, wt = key >> 3, key & 7
            f = fields.get(fnum)
            if f is None:
                pos = _skip(view, pos, wt)
                continue
            if wt == _WT_LEN:
                ln, pos = _read_varint(view, pos)
                if pos + ln > n:
                    raise ValueError("truncated length-delimited field")
                chunk = view[pos:pos + ln]
                pos += ln
                if f.ftype == MESSAGE:
                    sub = f.msg_cls()()
                    sub.merge_binary(chunk)
                    self._append(f, sub)
                elif f.ftype == STRING:
                    self._append(f, bytes(chunk).decode("utf-8", "replace"))
                elif f.ftype == BYTES:
                    self._append(f, bytes(chunk))
                elif (f.ftype == FLOAT and ln % 4 == 0) \
                        or (f.ftype == DOUBLE and ln % 8 == 0):
                    # packed float/double: bulk numpy decode, stored as
                    # an ndarray (list-compatible for our consumers)
                    import numpy as _np
                    arr = _np.frombuffer(
                        chunk, "<f4" if f.ftype == FLOAT else "<f8"
                    ).copy()
                    prev = self._values.get(f.name)
                    if prev is None or len(prev) == 0:
                        self._values[f.name] = arr
                    else:
                        self._values[f.name] = _np.concatenate(
                            [_np.asarray(prev, arr.dtype), arr])
                else:
                    # packed repeated scalars
                    p = 0
                    m = len(chunk)
                    while p < m:
                        v, p = _read_scalar(chunk, p, f)
                        self._append(f, v)
            elif wt == _WT_VARINT:
                v, pos = _read_varint(view, pos)
                self._append(f, _coerce_varint(f, v))
            elif wt == _WT_FIXED32:
                v = struct.unpack_from("<f" if f.ftype == FLOAT else "<I",
                                       view, pos)[0]
                pos += 4
                self._append(f, v)
            elif wt == _WT_FIXED64:
                v = struct.unpack_from("<d" if f.ftype == DOUBLE else "<Q",
                                       view, pos)[0]
                pos += 8
                self._append(f, v)
            else:
                raise ValueError(f"bad wire type {wt}")
        return self

    def _append(self, f: Field, v: Any) -> None:
        if f.repeated:
            cur = self._values.get(f.name)
            if cur is None:
                self._values[f.name] = [v]
            elif isinstance(cur, list):
                cur.append(v)
            else:  # ndarray from a packed fast-path decode; spec allows
                   # packed and unpacked elements interleaved
                self._values[f.name] = list(cur) + [v]
        else:
            self._values[f.name] = v


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------

def _write_varint(out, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def _write_key(out, fnum: int, wt: int) -> None:
    _write_varint(out, (fnum << 3) | wt)


def _write_scalar(out, f: Field, v) -> None:
    if f.ftype == FLOAT:
        out.write(struct.pack("<f", v))
    elif f.ftype == DOUBLE:
        out.write(struct.pack("<d", v))
    elif f.ftype in (SINT32, SINT64):
        _write_varint(out, (v << 1) ^ (v >> 63))
    elif f.ftype == BOOL:
        _write_varint(out, 1 if v else 0)
    else:
        _write_varint(out, int(v))


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _read_scalar(buf, pos: int, f: Field) -> Tuple[Any, int]:
    if f.ftype == FLOAT:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if f.ftype == DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    v, pos = _read_varint(buf, pos)
    return _coerce_varint(f, v), pos


def _coerce_varint(f: Field, v: int):
    if f.ftype == BOOL:
        return bool(v)
    if f.ftype in (SINT32, SINT64):
        return (v >> 1) ^ -(v & 1)
    if f.ftype == INT32:
        # negative int32 arrives as a 64-bit sign-extended varint
        v &= (1 << 32) - 1
        return v - (1 << 32) if v >= 1 << 31 else v
    if f.ftype == INT64:
        v &= (1 << 64) - 1
        return v - (1 << 64) if v >= 1 << 63 else v
    if f.ftype == FLOAT:  # float stored packed comes through _read_scalar
        return v
    return v


def _skip(view, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _read_varint(view, pos)
        return pos
    if wt == _WT_FIXED64:
        return pos + 8
    if wt == _WT_LEN:
        ln, pos = _read_varint(view, pos)
        if pos + ln > len(view):
            raise ValueError("truncated length-delimited field")
        return pos + ln
    if wt == _WT_FIXED32:
        return pos + 4
    raise ValueError(f"cannot skip wire type {wt}")


# ---------------------------------------------------------------------------
# text-format tokenizer / parser
# ---------------------------------------------------------------------------

class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)
        self.line = 1

    def _skip_ws(self):
        t, n = self.text, self.n
        while self.pos < n:
            c = t[self.pos]
            if c == "#":
                while self.pos < n and t[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r\n,":
                if c == "\n":
                    self.line += 1
                self.pos += 1
            else:
                return

    def peek(self) -> Optional[str]:
        self._skip_ws()
        if self.pos >= self.n:
            return None
        return self.text[self.pos]

    def next_token(self) -> str:
        self._skip_ws()
        if self.pos >= self.n:
            raise ValueError("unexpected end of prototxt")
        t = self.text
        c = t[self.pos]
        self.was_quoted = False
        if c in "{}:<>[];":
            self.pos += 1
            return c
        if c in "\"'":
            self.was_quoted = True
            return self._string(c)
        start = self.pos
        while (self.pos < self.n
               and t[self.pos] not in " \t\r\n{}:<>[]\"';,#"):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"bad token at line {self.line}: {c!r}")
        return t[start:self.pos]

    def _string(self, quote: str) -> str:
        # consumes a quoted string (with C escapes); adjacent strings concat
        out = []
        t = self.text
        self.pos += 1
        while True:
            if self.pos >= self.n:
                raise ValueError(f"unterminated string at line {self.line}")
            c = t[self.pos]
            if c == quote:
                self.pos += 1
                break
            if c == "\\":
                self.pos += 1
                if self.pos >= self.n:
                    raise ValueError(
                        f"unterminated string at line {self.line}")
                e = t[self.pos]
                if e in "01234567":
                    octs = e
                    while (len(octs) < 3 and self.pos + 1 < self.n
                           and t[self.pos + 1] in "01234567"):
                        self.pos += 1
                        octs += t[self.pos]
                    out.append(chr(int(octs, 8)))
                elif e == "x":
                    hx = ""
                    while (len(hx) < 2 and self.pos + 1 < self.n
                           and t[self.pos + 1] in "0123456789abcdefABCDEF"):
                        self.pos += 1
                        hx += t[self.pos]
                    if not hx:
                        raise ValueError(
                            f"bad \\x escape at line {self.line}")
                    out.append(chr(int(hx, 16)))
                else:
                    out.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", "'": "'", '"': '"',
                                "0": "\0"}.get(e, e))
                self.pos += 1
            else:
                out.append(c)
                self.pos += 1
        # implicit concatenation of adjacent string literals
        nxt = self.peek()
        if nxt in ("\"", "'"):
            out.append(self._string(nxt))
        return "".join(out)


_TRUE = {"true", "True", "1", "t"}
_FALSE = {"false", "False", "0", "f"}


def _parse_scalar(f: Field, tok_val: str):
    if f.ftype in (FLOAT, DOUBLE):
        return float(tok_val)
    if f.ftype == BOOL:
        if tok_val in _TRUE:
            return True
        if tok_val in _FALSE:
            return False
        raise ValueError(f"bad bool {tok_val!r} for field {f.name}")
    if f.ftype == ENUM:
        if tok_val.lstrip("-").isdigit():
            return int(tok_val)
        return f.enum.value(tok_val)
    if f.ftype == STRING:
        return tok_val
    if f.ftype == BYTES:
        return tok_val.encode("latin-1")
    return _parse_int(tok_val)


def _parse_int(tok: str) -> int:
    # protobuf text format: 0x.. hex, leading-zero octal, else decimal
    s = tok.lstrip("+-")
    sign = -1 if tok.startswith("-") else 1
    if s[:2].lower() == "0x":
        return sign * int(s, 16)
    if len(s) > 1 and s[0] == "0":
        return sign * int(s, 8)
    return sign * int(s, 10)


def _parse_fields(msg: Message, tok: _Tokenizer, *, top_level=False,
                  close: str = "}") -> None:
    fields = type(msg)._fields_by_name
    while True:
        c = tok.peek()
        if c is None:
            if top_level:
                return
            raise ValueError("unexpected EOF inside message block")
        if not top_level and c in (close, "}", ">"):
            tok.next_token()
            return
        name = tok.next_token()
        f = fields.get(name)
        if f is None:
            # protobuf TextFormat (and hence Caffe's ReadProtoFromText*)
            # fails on unknown fields — a typo'd config must not
            # silently misconfigure.  (Binary decode still skips
            # unknown tags for cross-fork caffemodel compat.)
            raise ValueError(
                f"line {tok.line}: unknown field {name!r} in "
                f"{type(msg).__name__}")
        c = tok.peek()
        if c == ":":
            tok.next_token()
            c = tok.peek()
        if c in ("{", "<"):
            opener = tok.next_token()
            closer = "}" if opener == "{" else ">"
            if f.ftype != MESSAGE:
                raise ValueError(f"field {name} is scalar but got a block")
            sub = f.msg_cls()()
            _parse_fields(sub, tok, close=closer)
            msg._append(f, sub)
        elif c == "[":
            # repeated scalar shorthand: f: [a, b, c]
            tok.next_token()
            while tok.peek() != "]":
                v = tok.next_token()
                _check_quoting(f, tok)
                msg._append(f, _parse_scalar(f, v))
            tok.next_token()
        else:
            v = tok.next_token()
            _check_quoting(f, tok)
            msg._append(f, _parse_scalar(f, v))


def _check_quoting(f: Field, tok: _Tokenizer) -> None:
    """TextFormat parity: string/bytes values must be quoted; numeric,
    bool, and enum values must not be."""
    quoted = getattr(tok, "was_quoted", False)
    if f.ftype in (STRING, BYTES):
        if not quoted:
            raise ValueError(
                f"line {tok.line}: string field {f.name!r} needs a "
                "quoted value")
    elif quoted:
        raise ValueError(
            f"line {tok.line}: field {f.name!r} ({f.ftype}) cannot take "
            "a quoted string value")



"""The port's own copy of the JAX package's ``kv/jute.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Jute wire-format primitives for the ZooKeeper client protocol.

ZooKeeper's RPC surface is length-prefixed packets of jute-serialized
records (big-endian ints/longs, length-prefixed strings/buffers). This
module implements the subset of records the kv layer needs: connect
handshake, request/reply headers, node Stat, the data ops
(create/delete/exists/getData/setData/getChildren2/check), multi
transactions, and watcher events.

Parity note: the reference reaches ZooKeeper through the external
kv-utils library (reference pom.xml:305-320; selected per-deployment the
same way etcd is — SURVEY.md §1 "Coordination substrate"). Here the
protocol codec is in-repo so the ZookeeperKV backend (kv/zookeeper.py)
and the conformance wire server (kv/zk_server.py) speak the real
byte format rather than a private stub dialect.

Only the fields the backend uses are modelled; ACLs are carried as the
fixed OPEN_ACL_UNSAFE world-anyone entry.
"""

from __future__ import annotations

import dataclasses
import io
import struct

# -- op codes (ZooKeeper protocol constants) -------------------------------

OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GET_DATA = 4
OP_SET_DATA = 5
OP_GET_CHILDREN = 8
OP_SYNC = 9
OP_PING = 11
OP_GET_CHILDREN2 = 12
OP_CHECK = 13
OP_MULTI = 14
OP_CREATE2 = 15
OP_CLOSE = -11
OP_ERROR = -1

# -- special xids ----------------------------------------------------------

XID_WATCH_EVENT = -1
XID_PING = -2

# -- error codes -----------------------------------------------------------

ERR_OK = 0
ERR_RUNTIME_INCONSISTENCY = -2
ERR_BAD_ARGUMENTS = -8
ERR_NO_NODE = -101
ERR_BAD_VERSION = -103
ERR_NODE_EXISTS = -110
ERR_NOT_EMPTY = -111
ERR_SESSION_EXPIRED = -112

# -- create flags ----------------------------------------------------------

FLAG_EPHEMERAL = 1
FLAG_SEQUENCE = 2

# -- watcher event types / states ------------------------------------------

EV_NODE_CREATED = 1
EV_NODE_DELETED = 2
EV_NODE_DATA_CHANGED = 3
EV_NODE_CHILDREN_CHANGED = 4
STATE_SYNC_CONNECTED = 3
STATE_EXPIRED = -112


class JuteError(ValueError):
    """Malformed jute payload."""


class Writer:
    def __init__(self) -> None:
        self._buf = io.BytesIO()

    def int32(self, v: int) -> "Writer":
        self._buf.write(struct.pack(">i", v))
        return self

    def int64(self, v: int) -> "Writer":
        self._buf.write(struct.pack(">q", v))
        return self

    def boolean(self, v: bool) -> "Writer":
        self._buf.write(b"\x01" if v else b"\x00")
        return self

    def string(self, s: str) -> "Writer":
        return self.buffer(s.encode("utf-8"))

    def buffer(self, b: bytes | None) -> "Writer":
        if b is None:
            self.int32(-1)
        else:
            self.int32(len(b))
            self._buf.write(b)
        return self

    def raw(self, b: bytes) -> "Writer":
        self._buf.write(b)
        return self

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class Reader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise JuteError(
                f"truncated jute payload: need {n} at {self._pos}, "
                f"have {len(self._data)}"
            )
        out = self._data[self._pos: self._pos + n]
        self._pos += n
        return out

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def boolean(self) -> bool:
        return self._take(1) != b"\x00"

    def string(self) -> str:
        return self.buffer().decode("utf-8")

    def buffer(self) -> bytes:
        n = self.int32()
        if n < 0:
            return b""
        if n > 64 << 20:
            raise JuteError(f"unreasonable buffer length {n}")
        return self._take(n)

    def remaining(self) -> int:
        return len(self._data) - self._pos


# -- records ---------------------------------------------------------------


@dataclasses.dataclass
class Stat:
    """Znode metadata (the fields carried on every data response).

    czxid/mzxid are GLOBAL transaction ids — they serve as the
    create/mod revisions of the KVStore mapping (kv/store.py KeyValue).
    """

    czxid: int = 0
    mzxid: int = 0
    ctime: int = 0
    mtime: int = 0
    version: int = 0
    cversion: int = 0
    aversion: int = 0
    ephemeral_owner: int = 0
    data_length: int = 0
    num_children: int = 0
    pzxid: int = 0

    def write(self, w: Writer) -> None:
        (w.int64(self.czxid).int64(self.mzxid).int64(self.ctime)
         .int64(self.mtime).int32(self.version).int32(self.cversion)
         .int32(self.aversion).int64(self.ephemeral_owner)
         .int32(self.data_length).int32(self.num_children)
         .int64(self.pzxid))

    @classmethod
    def read(cls, r: Reader) -> "Stat":
        return cls(
            czxid=r.int64(), mzxid=r.int64(), ctime=r.int64(),
            mtime=r.int64(), version=r.int32(), cversion=r.int32(),
            aversion=r.int32(), ephemeral_owner=r.int64(),
            data_length=r.int32(), num_children=r.int32(), pzxid=r.int64(),
        )


def write_acl_vector(w: Writer) -> None:
    """The fixed OPEN_ACL_UNSAFE vector: [perms=ALL(31), world:anyone]."""
    w.int32(1)
    w.int32(31)
    w.string("world")
    w.string("anyone")


def read_acl_vector(r: Reader) -> None:
    n = r.int32()
    for _ in range(max(0, n)):
        r.int32()      # perms
        r.string()     # scheme
        r.string()     # id


@dataclasses.dataclass
class ConnectRequest:
    protocol_version: int = 0
    last_zxid_seen: int = 0
    timeout_ms: int = 10_000
    session_id: int = 0
    passwd: bytes = b"\x00" * 16
    read_only: bool = False

    def encode(self) -> bytes:
        w = Writer()
        (w.int32(self.protocol_version).int64(self.last_zxid_seen)
         .int32(self.timeout_ms).int64(self.session_id).buffer(self.passwd)
         .boolean(self.read_only))
        return w.getvalue()

    @classmethod
    def decode(cls, data: bytes) -> "ConnectRequest":
        r = Reader(data)
        out = cls(
            protocol_version=r.int32(), last_zxid_seen=r.int64(),
            timeout_ms=r.int32(), session_id=r.int64(), passwd=r.buffer(),
        )
        if r.remaining():
            out.read_only = r.boolean()
        return out


@dataclasses.dataclass
class ConnectResponse:
    protocol_version: int = 0
    timeout_ms: int = 10_000
    session_id: int = 0
    passwd: bytes = b"\x00" * 16
    read_only: bool = False

    def encode(self) -> bytes:
        w = Writer()
        (w.int32(self.protocol_version).int32(self.timeout_ms)
         .int64(self.session_id).buffer(self.passwd).boolean(self.read_only))
        return w.getvalue()

    @classmethod
    def decode(cls, data: bytes) -> "ConnectResponse":
        r = Reader(data)
        out = cls(
            protocol_version=r.int32(), timeout_ms=r.int32(),
            session_id=r.int64(), passwd=r.buffer(),
        )
        if r.remaining():
            out.read_only = r.boolean()
        return out


@dataclasses.dataclass
class WatcherEvent:
    type: int
    state: int
    path: str

    def encode(self) -> bytes:
        w = Writer()
        w.int32(self.type).int32(self.state).string(self.path)
        return w.getvalue()

    @classmethod
    def read(cls, r: Reader) -> "WatcherEvent":
        return cls(type=r.int32(), state=r.int32(), path=r.string())


# -- framing ---------------------------------------------------------------


def frame(payload: bytes) -> bytes:
    return struct.pack(">i", len(payload)) + payload


def read_frame(sock) -> bytes:
    """Read one length-prefixed packet from a socket (blocking)."""
    header = _recv_exact(sock, 4)
    (n,) = struct.unpack(">i", header)
    if n < 0 or n > 64 << 20:
        raise JuteError(f"bad frame length {n}")
    return _recv_exact(sock, n)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# -- multi-op header -------------------------------------------------------


@dataclasses.dataclass
class MultiHeader:
    type: int
    done: bool
    err: int

    def write(self, w: Writer) -> None:
        w.int32(self.type).boolean(self.done).int32(self.err)

    @classmethod
    def read(cls, r: Reader) -> "MultiHeader":
        return cls(type=r.int32(), done=r.boolean(), err=r.int32())

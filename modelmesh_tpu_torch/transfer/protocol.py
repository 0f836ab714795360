"""The port's own copy of the JAX package's ``transfer/protocol.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Transfer protocol pieces: snapshots, fetch replies, streamability.

A transfer moves a model's weights as an ordered sequence of
``WeightChunk``s (runtime/spi.py). The sender serves chunks by index
from a ``TransferSnapshot`` — one immutable, host-RAM-resident
serialization of a loaded copy. Snapshots are what the ``HostTier``
stores, so one snapshot is simultaneously (a) the demotion artifact
that makes re-warm a device copy and (b) the O(1) peer-fetch source:
N receivers fetching the same model hit the same snapshot, never N
re-exports (the BLITZSCALE O(1) host-caching property).

The fetch RPC itself (``mesh_transfer.proto`` FetchWeights, served
beside Forward on the mesh-internal surface) is chunk-indexed and
stateless per call: receivers pull chunk 0..N-1, each reply carrying
the manifest (total chunks/bytes/layers + fingerprint) so a receiver
can detect truncation, sender restarts, and spec mismatches without
any per-transfer session state on the sender.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.runtime.spi import ModelInfo, WeightChunk

# Fetch reply status codes (proto FetchWeightsResponse.status).
FETCH_OK = 0
# Sender has no servable source for this model/fingerprint (no ACTIVE
# copy, no host-tier snapshot, snapshot too big for the host budget, or
# a spec mismatch). Receiver tries the next source / the store.
FETCH_NOT_AVAILABLE = 1


class TransferUnavailable(Exception):
    """Peer answered but cannot serve this transfer (NOT_AVAILABLE) —
    distinct from transport errors (peer death), though both fall back
    the same way."""


def model_fingerprint(info: ModelInfo) -> str:
    """Content identity of a model spec: a sender must only ever serve
    chunks for the exact (type, path, key) the receiver is loading — a
    re-registered model with the same id but a different path must miss."""
    h = hashlib.sha1()
    for part in (info.model_type, info.model_path, info.model_key):
        h.update(part.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def shard_fingerprint(info: ModelInfo, shard_index: int,
                      shard_count: int) -> str:
    """Content identity of ONE WEIGHT SHARD: the model fingerprint salted
    with the shard coordinates. A sharded holder exports its snapshot
    under this fingerprint, so a receiver loading shard k can never be
    served shard j's bytes by a same-model peer — the mismatch answers
    NOT_AVAILABLE instead of corrupting the graft. Full-copy snapshots
    keep the plain model fingerprint (receivers slice those by chunk
    index instead, see ``shard_chunk_indices``)."""
    h = hashlib.sha1()
    h.update(model_fingerprint(info).encode())
    h.update(f"|shard {shard_index}/{shard_count}".encode())
    return h.hexdigest()[:16]


def shard_chunk_indices(
    total_chunks: int, shard_index: int, shard_count: int
) -> range:
    """The contiguous chunk-index block shard ``shard_index`` owns inside
    a FULL snapshot of ``total_chunks`` chunks: chunks are emitted in
    canonical leaf order, so an even contiguous split assigns each shard
    a leaf-prefix-to-leaf-suffix slice — each receiver fetches only its
    own block (~total/shard_count of the bytes) instead of the whole
    stream. The first ``total_chunks % shard_count`` shards absorb the
    remainder, mirroring how the loader splits leaves."""
    if shard_count <= 0:
        return range(total_chunks)
    base, extra = divmod(total_chunks, shard_count)
    start = shard_index * base + min(shard_index, extra)
    size = base + (1 if shard_index < extra else 0)
    return range(start, start + size)


@dataclasses.dataclass(frozen=True)
class TransferSnapshot:
    """Immutable chunked serialization of one loaded model copy (the
    host-tier value type and the peer-fetch source)."""

    model_id: str
    fingerprint: str
    chunks: tuple[WeightChunk, ...]
    total_bytes: int            # accounted size (device bytes represented)
    total_layers: int
    created_ms: int

    @property
    def total_chunks(self) -> int:
        return len(self.chunks)

    @classmethod
    def build(
        cls,
        model_id: str,
        info: ModelInfo,
        chunks: Sequence[WeightChunk],
        total_bytes: int,
    ) -> "TransferSnapshot":
        layers = {c.layer for c in chunks if c.layer >= 0}
        return cls(
            model_id=model_id,
            fingerprint=model_fingerprint(info),
            chunks=tuple(chunks),
            total_bytes=int(total_bytes),
            total_layers=len(layers),
            created_ms=now_ms(),
        )


@dataclasses.dataclass(frozen=True)
class FetchReply:
    """One FetchWeights answer, transport-agnostic (the gRPC client and
    the in-process sim/bench transports all return this shape)."""

    status: int
    payload: bytes = b""
    seq: int = 0
    layer: int = -1
    last: bool = False
    total_chunks: int = 0
    total_bytes: int = 0
    total_layers: int = 0
    fingerprint: str = ""

    @property
    def ok(self) -> bool:
        return self.status == FETCH_OK

    def to_chunk(self) -> WeightChunk:
        return WeightChunk(
            seq=self.seq, payload=self.payload, layer=self.layer,
            last=self.last,
        )


# -- family streamability -----------------------------------------------------

# Families whose weights land layer-by-layer in a servable order, so a
# copy may admit requests mid-transfer (the PARTIAL entry phase). The
# authoritative declaration lives in models/families.py
# (LAYER_STREAMABLE_FAMILIES); this resolver parses the family out of a
# (model_type, model_path) spec lazily so the serving core never imports
# the model zoo just to route a store-only model.
_FALLBACK_STREAMABLE = frozenset({"transformer", "mlp"})


def is_layer_streamable(model_type: str, model_path: str) -> bool:
    family, sep, _ = (model_path or "").partition("://")
    if not sep:
        family = model_type
    family = (family or "").strip()
    # Consult the authoritative declaration only when the model zoo is
    # ALREADY imported (a process actually serving the port's families):
    # cold-importing torch here would stall a loading-pool thread — under
    # a virtual clock that blows the entire load budget. Store-only
    # processes use the static mirror of that set.
    import sys

    families = sys.modules.get("modelmesh_tpu_torch.models.families")
    if families is not None:
        return family in families.LAYER_STREAMABLE_FAMILIES
    return family in _FALLBACK_STREAMABLE


def snapshot_reply(snap: Optional[TransferSnapshot], chunk_index: int,
                   fingerprint: str) -> FetchReply:
    """Sender-side: answer one chunk-indexed fetch from a snapshot."""
    if (
        snap is None
        or (fingerprint and snap.fingerprint != fingerprint)
        or chunk_index < 0
        or chunk_index >= snap.total_chunks
    ):
        return FetchReply(status=FETCH_NOT_AVAILABLE)
    c = snap.chunks[chunk_index]
    return FetchReply(
        status=FETCH_OK,
        payload=c.payload,
        seq=c.seq,
        layer=c.layer,
        last=c.last,
        total_chunks=snap.total_chunks,
        total_bytes=snap.total_bytes,
        total_layers=snap.total_layers,
        fingerprint=snap.fingerprint,
    )

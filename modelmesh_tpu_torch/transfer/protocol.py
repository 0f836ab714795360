"""Weight-transfer protocol helpers the model server needs.

The port's copy of ``shard_chunk_indices`` from the JAX package's
``transfer/protocol.py``, unchanged.
"""

from __future__ import annotations


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

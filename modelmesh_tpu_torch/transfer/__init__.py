"""The port's own copy of the JAX package's ``transfer/``.

Weight-transfer subsystem: peer-to-peer streaming + tiered host caching.

Live scale-up per BLITZSCALE (PAPERS.md): a new copy of a hot model
streams its weights from an already-loaded peer (or this host's own
RAM staging tier) instead of paying another model-store load, and
layer-streamable families begin serving mid-transfer. Pieces:

- ``protocol``  — chunk wire format, transfer snapshots (the host-tier
  value type), fetch status codes, family streamability traits.
- ``manager``   — per-instance ``WeightTransferManager``: source
  resolution (host tier -> live peer -> wait-for-pending -> store),
  receiver-side streaming with store fallback, sender-side fetch
  serving, and demotion of evicted copies into the host tier.

The runtime SPI half lives in ``runtime/spi.py`` (``export_weights`` /
``load_from_stream`` / ``supports_weight_streaming``); the host-RAM
tier itself is ``cache/lru.py:HostTier``.
"""

from modelmesh_tpu_torch.transfer.protocol import (  # noqa: F401
    FETCH_NOT_AVAILABLE,
    FETCH_OK,
    FetchReply,
    TransferSnapshot,
    TransferUnavailable,
    is_layer_streamable,
    model_fingerprint,
)
from modelmesh_tpu_torch.transfer.manager import (  # noqa: F401
    TransferConfig,
    WeightTransferManager,
)

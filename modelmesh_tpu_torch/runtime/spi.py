"""Model-loading SPI: what the serving core calls to manage model copies.

The port's own copy of the JAX package's ``runtime/spi.py`` (the port
imports nothing of that package), with the same classes and method
signatures, so a port loader is what the serving core expects. Parity with the reference's per-type loading interface
(MM/ModelLoader.java:36-98: predictSize/modelSize/loadRuntime/unloadModel)
and the startup parameter block (MM/LocalInstanceParameters.java:26-124).
Sizes here are plain bytes; the cache's accounting unit (CACHE_UNIT_BYTES)
is applied by the serving layer.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Generic, Iterator, Optional, TypeVar

# Cache accounting unit (reference: 8 KiB, ModelLoader.java:37).
CACHE_UNIT_BYTES = 8 * 1024

T = TypeVar("T")  # runtime handle type for a loaded model


@dataclasses.dataclass(frozen=True)
class ModelInfo:
    model_type: str
    model_path: str = ""
    model_key: str = ""


@dataclasses.dataclass(frozen=True)
class LocalInstanceParams:
    """Instance runtime parameters, produced by loader startup.

    Defaults match the reference envelope (BASELINE.md): 8 loading threads,
    240 s load timeout.
    """

    capacity_bytes: int
    load_concurrency: int = 8
    load_timeout_ms: int = 240_000
    default_model_size_bytes: int = 1 << 20
    limit_model_concurrency: bool = False

    @property
    def capacity_units(self) -> int:
        return max(self.capacity_bytes // CACHE_UNIT_BYTES, 1)


class ModelLoadException(Exception):
    def __init__(self, message: str, timeout: bool = False):
        super().__init__(message)
        self.timeout = timeout


class ModelNotLoadedError(Exception):
    """Runtime no longer has the model (the NOT_FOUND-on-serve case);
    the serving layer purges its entry and retries elsewhere."""


@dataclasses.dataclass(frozen=True)
class BatchItem:
    """One request inside a batched runtime dispatch
    (``ModelLoader.call_model_batch``). ``headers`` is the per-request
    metadata list exactly as ``call_model`` receives it."""

    model_id: str
    method: str = ""
    payload: bytes = b""
    headers: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class WeightChunk:
    """One unit of a streamed weight transfer (peer fetch / host-tier
    re-warm). ``layer`` tags the model layer this chunk completes for
    layer-streamable families (-1 = not layer-aligned); ``last`` marks
    the end of the stream so a receiver can distinguish a complete
    transfer from a truncated one."""

    seq: int
    payload: bytes
    layer: int = -1
    last: bool = False


class ModelLoader(abc.ABC, Generic[T]):
    """Per-instance loading SPI. All methods may block; the serving core
    runs them on its loading pool with timeouts."""

    @abc.abstractmethod
    def startup(self) -> LocalInstanceParams:
        """Block until the runtime is ready; return instance parameters
        (reference: SidecarModelMesh.startup() polling runtimeStatus,
        SidecarModelMesh.java:157-232)."""

    @abc.abstractmethod
    def load(self, model_id: str, info: ModelInfo) -> "LoadedModel[T]":
        """Load; raise ModelLoadException on failure."""

    def predict_size(self, model_id: str, info: ModelInfo) -> int:
        """Estimated bytes before loading. 0 = unknown."""
        return 0

    def model_size(self, model_id: str, handle: T) -> int:
        """Measured bytes of a loaded model. 0 = unknown."""
        return 0

    def unload(self, model_id: str) -> None:
        """Release a loaded model. Must be idempotent."""

    @property
    def requires_unload(self) -> bool:
        """True if capacity isn't freed until unload completes (drives the
        unload-buffer accounting, ModelCacheUnloadBufManager)."""
        return True

    # -- batched dispatch (optional capability; serving/batching.py) -------

    @property
    def supports_batched_dispatch(self) -> bool:
        """True when ``call_model_batch`` executes a whole micro-batch as
        one (or few) real runtime dispatches, so the serving layer's
        continuous-batching queue is worth putting in front of this
        loader. The default loop-over-singles implementation keeps
        ``call_model_batch`` callable everywhere, but a loader that
        merely loops gains nothing from queueing — the serving layer
        only engages the batch queue when this flag is True (or an
        explicit batched runtime call is injected)."""
        return False

    def call_model_batch(self, items: list[BatchItem], cancel_event=None):
        """Execute a micro-batch of inference requests.

        Returns a list aligned with ``items``; each entry is either the
        response ``bytes`` or an ``Exception`` instance failing THAT
        item (per-item isolation — one malformed payload must not fail
        its batch-mates). A raised exception fails the whole batch.

        Default: loop over ``call_model`` singles with per-item error
        isolation, so sidecar/fake/bench loaders keep working unchanged.
        """
        call_model = getattr(self, "call_model", None)
        if call_model is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no call_model"
            )
        out: list = []
        for item in items:
            try:
                out.append(call_model(
                    item.model_id, item.method, item.payload,
                    item.headers, cancel_event=cancel_event,
                ))
            except Exception as e:  # noqa: BLE001 — per-item isolation
                out.append(e)
        return out

    def batch_group_key(self, model_id: str) -> str:
        """Micro-batch grouping key: requests whose models share a key
        may ride one dispatch. Default = the model id (per-model
        batching only); a fused-dispatch-capable loader returns a shared
        architecture key for co-located same-family models so
        cross-model requests fuse into one kernel."""
        return model_id

    # -- weight streaming (optional capability; transfer/ subsystem) -------

    @property
    def supports_weight_streaming(self) -> bool:
        """True when this loader implements the ``export_weights`` /
        ``load_from_stream`` pair. The serving layer gates every transfer
        decision (peer fetch, host-tier demotion, serve-before-loaded) on
        this flag — a plain store-only loader is never asked to stream."""
        return False

    def export_weights(
        self, model_id: str, handle: T
    ) -> Optional[Iterator[WeightChunk]]:
        """Serialize a LOADED model's weights as an ordered chunk stream
        (the peer-fetch / host-demotion source). None = unsupported or the
        runtime can't export this model right now. Chunks must be
        reproducible for the same loaded copy; the final chunk must carry
        ``last=True``."""
        return None

    def load_from_stream(
        self,
        model_id: str,
        info: ModelInfo,
        chunks: Iterator[WeightChunk],
        partial_ready: Optional[Callable[["LoadedModel[T]"], None]] = None,
    ) -> "LoadedModel[T]":
        """Materialize a model from a chunk stream instead of the model
        store (peer fetch or host-tier re-warm).

        Contract: loader-side failures raise ``ModelLoadException``;
        exceptions raised BY the chunk iterator (peer death, stream error
        mid-transfer) must propagate unwrapped so the serving layer can
        fall back to a store load. ``partial_ready(loaded)`` may be called
        at most once, as soon as enough layers have landed to serve
        requests (layer-streamable families only) — the handle passed must
        already be usable for inference at that point.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support weight streaming"
        )

    # -- sharded execution (optional capability; placement groups) ---------

    @property
    def supports_sharded_execution(self) -> bool:
        """True when this loader can materialize and serve ONE SHARD of a
        model (``load_shard`` / ``load_shard_from_stream``) — the runtime
        half of the sharded-execution subsystem. The serving layer only
        plans multi-instance placement groups for models whose loader
        declares this; everyone else keeps the single-copy contract (an
        oversized model simply fails to place, as before)."""
        return False

    def load_shard(
        self, model_id: str, info: ModelInfo, shard_index: int,
        shard_count: int,
    ) -> "LoadedModel[T]":
        """Materialize shard ``shard_index`` of ``shard_count`` from the
        model store. The returned size must be the SHARD's resident
        bytes (≈ total/shard_count) — that is what the cache accounts.
        Raise ModelLoadException on failure."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support sharded execution"
        )

    def load_shard_from_stream(
        self,
        model_id: str,
        info: ModelInfo,
        shard_index: int,
        shard_count: int,
        chunks: Iterator[WeightChunk],
    ) -> "LoadedModel[T]":
        """Materialize one shard from a transfer stream carrying ONLY
        that shard's chunks (a peer holding the same shard, or the
        shard-sliced subset of a full snapshot). Same error contract as
        ``load_from_stream``: loader failures raise ModelLoadException,
        iterator failures propagate unwrapped so the transfer manager
        can fall back to ``load_shard`` from the store. No
        ``partial_ready``: a shard is already the minimal servable
        granule — serve-before-loaded composes at the GROUP level (the
        group serves when every shard has landed), not within a shard."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support sharded execution"
        )


@dataclasses.dataclass
class LoadedModel(Generic[T]):
    handle: T
    size_bytes: int = 0            # 0 = needs post-load sizing
    max_concurrency: int = 0       # 0 = unlimited

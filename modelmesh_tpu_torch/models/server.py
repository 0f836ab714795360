"""PyTorch model server: a ModelRuntime serving the model families on the card.

Port of ``modelmesh_tpu/models/server.py``: the same runtime SPI (status
handshake, load/unload/size, raw-bytes predict) over models built by
``models/families.py`` and resident in the memory of one device. One
process per instance behind the serving core's sidecar client
(``--runtime sidecar:HOST:PORT``), or mounted in-process through
``InProcessTorchLoader``.

Every entry point takes ``device``: ``None`` means ``cuda:0`` and raises
without a CUDA device; ``device="cpu"`` is the caller's explicit choice.
They also take ``devices``, the devices a model may span (``None``:
``[device]``; ``"auto"``: every device of ``device``'s type, the
reference's ``jax.devices()``; a list may name one device more than
once): the transformer's ``sp=1``/``ep=1`` run over them, and
``load_sharded`` splits weights over the serving mesh on them. The models
on one mesh take turns on it (``Mesh.run`` serves one call at a time).

Run standalone:
    python -m modelmesh_tpu_torch.models.server --port 8085 --capacity-mb 1024
"""

from __future__ import annotations

import argparse
import logging
import threading
from concurrent import futures
from typing import Optional

import grpc
import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.models.families import (
    LAYER_STREAMABLE_FAMILIES,
    ModelSpec,
    ServableModel,
    build_model,
    leaf_bytes,
    leaf_from_bytes,
    leaves,
    map_tree,
    unflatten,
)
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
from modelmesh_tpu_torch.runtime import grpc_defs
from modelmesh_tpu_torch.runtime.spi import (
    LoadedModel,
    LocalInstanceParams,
    ModelInfo,
    ModelLoader,
    ModelLoadException,
    ModelNotLoadedError,
    WeightChunk,
)
from modelmesh_tpu_torch.transfer.protocol import shard_chunk_indices
from modelmesh_tpu_torch.utils import envs
from modelmesh_tpu_torch.utils.grpcopts import message_size_options

log = logging.getLogger(__name__)

# The reference's method name, kept for wire compatibility with its clients.
PREDICT_METHOD = "/mmtpu.models.JaxPredictor/Predict"


def _warm(model: ServableModel) -> None:
    """One predict of a zero row, so the first request pays no warm-up."""
    model.run(np.zeros((1, *model.input_shape), model.input_dtype))


def resolve_devices(devices, device: torch.device) -> list[torch.device]:
    """The devices a store's models may span: ``None`` -> ``[device]``;
    ``"auto"`` -> every device of ``device``'s type (every CUDA device, or
    the host); else the list as given."""
    if devices is None:
        return [device]
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices={devices!r}: a list or 'auto'")
        return (mesh_mod.cuda_devices() if device.type == "cuda"
                else [device])
    return [torch.device(d) for d in devices]


def shard_servable(model: ServableModel, mesh) -> ServableModel:
    """A built model's parameters split over the serving mesh by
    ``param_pspec`` (weight matrices column-split on ``mdl``, the rest
    replicated), with the family's apply unchanged: its products run
    column-parallel on the blocks' devices. ``fuse_key`` is cleared: a
    split copy never stacks into a fused group (the stack would gather
    the blocks and undo the memory split)."""
    return ServableModel(
        model.apply, mesh_mod.shard_params(model.params, mesh),
        model.input_shape, model.input_dtype, family=model.family,
        fuse_key="", batch_safe=model.batch_safe,
    )


class TorchModelStore:
    """Loaded-model registry shared by the gRPC and in-process fronts.

    Beyond single-request ``predict_bytes``, the store executes whole
    micro-batches (``predict_batch``): requests for ONE model ride a
    single row-concatenated call, and requests for several co-located
    same-architecture models of a layer-streamable family fuse into ONE
    stacked call — parameter trees stacked along a leading model axis,
    ``torch.func.vmap``'d apply, per-request model-index route. Stacked
    parameter groups and fused callables are cached (invalidated on
    unload / reinstall) so steady-state fused dispatches pay no
    re-stacking.
    """

    # Bounded caches. Stacked groups are weights-sized: ONE entry per
    # fuse_key (the FULL co-located group), never per batch-membership
    # subset. Fused fns are small.
    _MAX_STACKED = 8
    _MAX_FUSED_FNS = 32

    def __init__(self, capacity_bytes: int, device=None, devices=None):
        self.capacity_bytes = capacity_bytes
        self.device = device_mod.resolve_device(device)
        device_mod.check_cublas_import_order(self.device)
        self.devices = resolve_devices(devices, self.device)
        self._models: dict[str, ServableModel] = {}
        self._lock = threading.Lock()
        # Operator gate for the fused cross-model path (tests flip the
        # attribute directly; the env is process-fixed).
        self.fused_enabled = envs.get_bool("MM_FUSED_DISPATCH")
        # fuse_key -> (sorted member-id tuple, stacked tree, member object
        # tuple, stacked bytes): the FULL group's stacked parameters
        self._stacked: dict[str, tuple] = {}  #: guarded-by: _lock
        # fuse_key -> vmap(apply) over (stacked params, [M, C, ...])
        self._fused_fns: dict[str, object] = {}  #: guarded-by: _lock
        # Fused dispatches run, and fused dispatches that fell back to
        # per-model calls (a membership race, as in the reference).
        self.fused_dispatches = 0  #: guarded-by: _lock
        self.fused_fallbacks = 0  #: guarded-by: _lock

    def load(self, model_id: str, model_type: str, model_path: str) -> int:
        with self._lock:
            existing = self._models.get(model_id)
            if existing is not None:
                return existing.size_bytes
        model = build_model(model_id, model_type, model_path,
                            device=self.device, devices=self.devices)
        _warm(model)
        with self._lock:
            self._models[model_id] = model
        return model.size_bytes

    def load_sharded(self, model_id: str, model_type: str,
                     model_path: str, mesh=None) -> int:
        """Load with the weights split over the serving mesh (``mesh``;
        ``None``: ``serving_mesh`` over this store's devices): each
        weight matrix column-split on ``mdl``, the rest replicated
        (``shard_servable``). Restricted to LAYER_STREAMABLE_FAMILIES,
        whose compute is dense per-layer products, so the column split is
        always valid. On a one-shard mesh every leaf is replicated and the
        model computes bit for bit what ``load`` computes. Returns the
        whole model's bytes."""
        with self._lock:
            existing = self._models.get(model_id)
            if existing is not None:
                return existing.size_bytes
        model = build_model(model_id, model_type, model_path,
                            device=self.device, devices=self.devices)
        if model.family not in LAYER_STREAMABLE_FAMILIES:
            raise ValueError(
                f"family {model.family!r} is not sharded-executable "
                f"(layer-streamable families only: "
                f"{sorted(LAYER_STREAMABLE_FAMILIES)})"
            )
        model = shard_servable(
            model, mesh or mesh_mod.serving_mesh(devices=self.devices))
        _warm(model)
        with self._lock:
            self._models[model_id] = model
        return model.size_bytes

    def install(self, model_id: str, model: ServableModel) -> None:
        """Register an externally-materialized model (stream-loaded)."""
        with self._lock:
            self._models[model_id] = model
            self._drop_stacked_locked(model_id)

    def unload(self, model_id: str) -> bool:
        with self._lock:
            self._drop_stacked_locked(model_id)
            return self._models.pop(model_id, None) is not None

    def _drop_stacked_locked(self, model_id: str) -> None:
        """Invalidate stacked-parameter groups containing the model."""
        self._stacked = {
            key: entry for key, entry in self._stacked.items()
            if model_id not in entry[0]
        }

    def get(self, model_id: str) -> Optional[ServableModel]:
        with self._lock:
            return self._models.get(model_id)

    def size(self, model_id: str) -> int:
        m = self.get(model_id)
        return m.size_bytes if m else 0

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return sum(
                m.size_bytes for m in self._models.values()
            ) + self._stacked_bytes_locked()

    def _stacked_bytes_locked(self) -> int:
        return sum(entry[3] for entry in self._stacked.values())

    # -- batched execution -------------------------------------------------

    def predict_batch(self, items: list[tuple[str, bytes]]) -> list:
        """Execute a micro-batch of (model_id, payload) requests.

        Returns a list aligned with ``items``; entries are response
        bytes or Exception instances (per-item isolation). All requests
        for one model share a single row-concatenated call; a multi-model
        batch whose members share a fuse key executes as one stacked
        fused call, and per model when architectures diverge.
        """
        results: list = [None] * len(items)
        # model_id -> (mid, model, [(result_index, decoded rows)])
        per_model: dict[str, tuple] = {}
        for i, (mid, payload) in enumerate(items):
            model = self.get(mid)
            if model is None:
                results[i] = ModelNotLoadedError(mid)
                continue
            try:
                rows = model.decode_rows(payload)
            except Exception as e:  # noqa: BLE001 — per-item isolation
                results[i] = ValueError(f"bad payload: {e}")
                continue
            per_model.setdefault(mid, (mid, model, []))[2].append((i, rows))
        groups = [per_model[mid] for mid in sorted(per_model)]
        if len(groups) > 1 and self._fusable(groups):
            self._predict_fused(groups, results)
        else:
            for _, model, reqs in groups:
                self._predict_single(model, reqs, results)
        return results

    def _fusable(self, groups: list[tuple]) -> bool:
        if not self.fused_enabled:
            return False
        keys = {model.fuse_key for _, model, _ in groups}
        families = {model.family for _, model, _ in groups}
        return (
            len(keys) == 1
            and "" not in keys
            and families <= LAYER_STREAMABLE_FAMILIES
            and all(model.batch_safe for _, model, _ in groups)
        )

    @staticmethod
    def _row_bucket(n: int) -> int:
        """Round a batch's row count up to a power of two, as the
        reference does (it compiles per input shape; here it keeps the
        set of shapes a device sees small). Every family is
        row-independent, so the zero padding rows can't perturb real
        outputs."""
        b = 1
        while b < n:
            b <<= 1
        return b

    @classmethod
    def _predict_single(
        cls, model: ServableModel, reqs: list, results: list
    ) -> None:
        """One model's requests as one row-concatenated call (row count
        padded to the shape bucket, outputs sliced back). Batch-coupled
        models run per request with exact solo shapes."""
        if not model.batch_safe:
            for i, rows in reqs:
                try:
                    results[i] = model.run(rows).tobytes()
                except Exception as e:  # noqa: BLE001 — per-item
                    results[i] = e
            return
        try:
            total = sum(rows.shape[0] for _, rows in reqs)
            if len(reqs) == 1 and reqs[0][1].shape[0] == cls._row_bucket(total):
                x = reqs[0][1]
            else:
                x = np.zeros(
                    (cls._row_bucket(total), *model.input_shape),
                    model.input_dtype,
                )
                ofs = 0
                for _, rows in reqs:
                    x[ofs: ofs + rows.shape[0]] = rows
                    ofs += rows.shape[0]
            out = model.run(x)
            ofs = 0
            for i, rows in reqs:
                n = rows.shape[0]
                results[i] = out[ofs: ofs + n].tobytes()
                ofs += n
        except Exception as e:  # noqa: BLE001 — fail this model's items
            for i, _ in reqs:
                results[i] = e

    def _predict_fused(self, groups: list[tuple], results: list) -> None:
        """Multi-model micro-batch as ONE stacked call: the FULL
        co-located fuse group's parameters stacked [M_full, ...], inputs
        [M_full, C, ...] with each batched model's rows at its group
        index (absent members ride zero rows — row/model independence
        means they can't perturb real outputs), vmapped apply. When the
        fused call cannot run (a batched model raced an unload or a
        membership change), the batch runs per model on the same device,
        as the reference does; ``fused_fallbacks`` counts those."""
        try:
            rep = groups[0][1]
            member_ids, stacked, members = self._full_group_stack(
                rep.fuse_key
            )[:3]
            index = {mid: g for g, mid in enumerate(member_ids)}
            if any(
                mid not in index or members[index[mid]] is not model
                for mid, model, _ in groups
            ):
                raise LookupError("fuse-group membership moved")
            counts = [
                sum(rows.shape[0] for _, rows in reqs)
                for _, _, reqs in groups
            ]
            cap = self._row_bucket(max(counts))
            x = np.zeros(
                (len(member_ids), cap, *rep.input_shape), rep.input_dtype
            )
            for mid, _, reqs in groups:
                g, ofs = index[mid], 0
                for _, rows in reqs:
                    x[g, ofs: ofs + rows.shape[0]] = rows
                    ofs += rows.shape[0]
            fn = self._fused_fn(rep)
            xt = torch.from_numpy(x).to(rep.device)
            with torch.inference_mode():
                out = fn(stacked, xt).to(torch.float32).cpu().numpy()
            for mid, _, reqs in groups:
                g, ofs = index[mid], 0
                for i, rows in reqs:
                    n = rows.shape[0]
                    results[i] = out[g, ofs: ofs + n].tobytes()
                    ofs += n
            with self._lock:
                self.fused_dispatches += 1
        except Exception:  # noqa: BLE001 — membership moved mid-flight etc.
            log.warning(
                "fused dispatch over %d models failed; falling back "
                "per-model", len(groups), exc_info=True,
            )
            with self._lock:
                self.fused_fallbacks += 1
            for _, model, reqs in groups:
                self._predict_single(model, reqs, results)

    def _current_members_locked(self, fuse_key: str):
        """Sorted (ids, models) of every loaded model sharing the
        architecture. Callers hold _lock."""
        members = sorted(
            ((mid, m) for mid, m in self._models.items()
             if m.fuse_key == fuse_key),
            key=lambda pair: pair[0],
        )
        return (
            tuple(mid for mid, _ in members),
            tuple(m for _, m in members),
        )

    def _full_group_stack(self, fuse_key: str):
        """(member_ids, stacked, members, bytes) over the FULL co-located
        group: one cached weights-duplicate per architecture, rebuilt
        whenever membership or any member's identity moved."""
        with self._lock:
            ids, models = self._current_members_locked(fuse_key)
            cached = self._stacked.get(fuse_key)
            if (
                cached is not None
                and cached[0] == ids
                and cached[2] == models
            ):
                return cached
        stacked = map_tree(
            lambda *ls: torch.stack(ls), *[m.params for m in models]
        )
        stack_bytes = sum(m.size_bytes for m in models)
        entry = (ids, stacked, models, stack_bytes)
        with self._lock:
            # Re-validate at insert time: a concurrent install()/load may
            # have moved the group while we stacked the OLD objects.
            cur_ids, cur_models = self._current_members_locked(fuse_key)
            if cur_ids == ids and cur_models == models:
                # Byte-budgeted against capacity (and counted in
                # used_bytes); an over-budget stack is used once and
                # dropped.
                model_bytes = sum(
                    m.size_bytes for m in self._models.values()
                )
                budget = max(self.capacity_bytes - model_bytes, 0)
                if stack_bytes <= budget:
                    # Evict only when eviction can actually make room.
                    while self._stacked and (
                        len(self._stacked) >= self._MAX_STACKED
                        or self._stacked_bytes_locked() + stack_bytes
                        > budget
                    ):
                        self._stacked.pop(next(iter(self._stacked)))
                    if self._stacked_bytes_locked() + stack_bytes <= budget:
                        self._stacked[fuse_key] = entry
        return entry

    def _fused_fn(self, rep: ServableModel):
        """vmap(apply) for the group's architecture, cached per fuse key —
        the representative's apply runs every member's stacked
        parameters (equal fuse keys guarantee identical semantics)."""
        with self._lock:
            fn = self._fused_fns.get(rep.fuse_key)
        if fn is not None:
            return fn
        fn = torch.func.vmap(rep.apply, in_dims=(0, 0))
        with self._lock:
            while len(self._fused_fns) >= self._MAX_FUSED_FNS:
                self._fused_fns.pop(next(iter(self._fused_fns)))
            self._fused_fns[rep.fuse_key] = fn
        return fn


def predict_size_estimate(model_type: str, model_path: str) -> int:
    """Parameter-count-based size estimate without building the model
    (the reference's estimate, unchanged: it counts 2 bytes a parameter)."""
    spec = ModelSpec.parse(model_type, model_path)
    p = spec.params
    if spec.family == "mlp":
        d_in, hidden = p.get("in", 64), p.get("hidden", 256)
        depth, d_out = p.get("depth", 2), p.get("out", 10)
        n = d_in * hidden + hidden * hidden * max(0, depth - 1) + hidden * d_out
        return 2 * n + 2 * (hidden * depth + d_out)
    if spec.family in ("linear", "example"):
        return 2 * p.get("in", 32) * p.get("out", 8)
    if spec.family == "transformer":
        vocab, d = p.get("vocab", 256), p.get("d", 128)
        layers, seq = p.get("layers", 2), p.get("seq", 64)
        per_layer = 3 * d * d + d * d + 8 * d * d + 2 * d
        return 2 * (vocab * d + seq * d + layers * per_layer)
    if spec.family == "conv":
        size, chans = p.get("size", 32), p.get("chans", 3)
        width, depth = p.get("width", 16), p.get("depth", 3)
        classes = p.get("classes", 10)
        n, c_in = 0, chans
        for i in range(depth):
            c_out = width << i
            n += 9 * c_in * c_out + c_out
            c_in = c_out
        hw = size
        for _ in range(depth):
            hw = max(1, (hw + 1) // 2)  # ceil: SAME + stride 2 per block
        return 2 * (n + hw * hw * c_in * classes)
    if spec.family == "embedding":
        vocab, dim = p.get("vocab", 4096), p.get("dim", 64)
        items = p.get("items", 128)
        return 2 * (vocab * dim + items * dim)
    return 1 << 20


class TorchRuntimeServicer:
    """gRPC ModelRuntime implementation over a TorchModelStore."""

    def __init__(self, store: TorchModelStore, load_concurrency: int = 4):
        self.store = store
        self.load_concurrency = load_concurrency

    def RuntimeStatus(self, request, context):
        dev = self.store.device
        device_bytes = (
            torch.cuda.get_device_properties(dev).total_memory
            if dev.type == "cuda" else 0
        )
        return rpb.RuntimeStatusResponse(
            status=rpb.RuntimeStatusResponse.READY,
            capacity_bytes=self.store.capacity_bytes,
            load_concurrency=self.load_concurrency,
            load_timeout_ms=120_000,
            default_model_size_bytes=1 << 20,
            device_memory_bytes=device_bytes,
            runtime_version=f"torch-runtime/{dev.type}",
        )

    def LoadModel(self, request, context):
        try:
            size = self.store.load(
                request.model_id,
                request.info.model_type,
                request.info.model_path,
            )
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:  # noqa: BLE001 — loading failure
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        return rpb.LoadModelResponse(size_bytes=size)

    def UnloadModel(self, request, context):
        self.store.unload(request.model_id)
        return rpb.UnloadModelResponse()

    def PredictModelSize(self, request, context):
        return rpb.ModelSizeResponse(
            size_bytes=predict_size_estimate(
                request.info.model_type, request.info.model_path
            )
        )

    def ModelSize(self, request, context):
        return rpb.ModelSizeResponse(size_bytes=self.store.size(request.model_id))

    def predict(self, method: str, payload: bytes, context) -> bytes:
        md = dict(context.invocation_metadata())
        model_id = md.get(grpc_defs.MODEL_ID_HEADER, "")
        model = self.store.get(model_id)
        if model is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"model {model_id} not loaded"
            )
        try:
            return model.predict_bytes(payload)
        except Exception as e:  # noqa: BLE001 — inference failure
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad payload: {e}")


def start_torch_runtime(
    port: int = 0,
    capacity_bytes: int = 256 << 20,
    max_workers: int = 16,
    uds_path: str = "",
    device=None,
    devices=None,
) -> tuple[grpc.Server, int, TorchRuntimeServicer]:
    """Start the runtime's gRPC server; returns (server, bound port,
    servicer). The caller stops the server."""
    store = TorchModelStore(capacity_bytes, device, devices)
    servicer = TorchRuntimeServicer(store)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=message_size_options(),
    )
    grpc_defs.add_servicer(
        server, servicer, grpc_defs.RUNTIME_SERVICE, grpc_defs.RUNTIME_METHODS
    )
    server.add_generic_rpc_handlers(
        (grpc_defs.RawFallbackHandler(servicer.predict),)
    )
    bound = grpc_defs.bind_server(server, port, uds_path=uds_path)
    server.start()
    return server, bound, servicer


def _chunks(blob: bytes, chunk_bytes: int) -> list[bytes]:
    return [
        blob[i: i + chunk_bytes] for i in range(0, len(blob), chunk_bytes)
    ] or [b""]


def _by_layer(chunks) -> dict[int, list[bytes]]:
    by_layer: dict[int, list[bytes]] = {}
    for chunk in chunks:
        by_layer.setdefault(chunk.layer, []).append(chunk.payload)
    return by_layer


class InProcessTorchLoader(ModelLoader[ServableModel]):
    """ModelLoader serving models in the SAME process as the mesh
    instance — no sidecar hop; the runtime handle is the ServableModel."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 load_concurrency: int = 4, device=None, devices=None):
        self.store = TorchModelStore(capacity_bytes, device, devices)
        self._load_concurrency = load_concurrency

    def startup(self) -> LocalInstanceParams:
        return LocalInstanceParams(
            capacity_bytes=self.store.capacity_bytes,
            load_concurrency=self._load_concurrency,
            load_timeout_ms=120_000,
            default_model_size_bytes=1 << 20,
        )

    def load(self, model_id: str, info: ModelInfo) -> LoadedModel[ServableModel]:
        try:
            size = self.store.load(model_id, info.model_type, info.model_path)
        except Exception as e:  # noqa: BLE001
            raise ModelLoadException(f"{type(e).__name__}: {e}") from e
        return LoadedModel(handle=self.store.get(model_id), size_bytes=size)

    def predict_size(self, model_id: str, info: ModelInfo) -> int:
        return predict_size_estimate(info.model_type, info.model_path)

    def model_size(self, model_id: str, handle: ServableModel) -> int:
        return handle.size_bytes if handle else self.store.size(model_id)

    def unload(self, model_id: str) -> None:
        self.store.unload(model_id)

    def call_model(
        self, model_id: str, full_method: str, payload: bytes,
        headers=None, timeout_s=None, cancel_event=None,
    ) -> bytes:
        model = self.store.get(model_id)
        if model is None:
            raise ModelNotLoadedError(model_id)
        return model.predict_bytes(payload)

    # -- batched dispatch (the serving core's batching data plane) ---------

    @property
    def supports_batched_dispatch(self) -> bool:
        """The store executes micro-batches as real single calls
        (row-concat per model, stacked vmap across fused same-family
        models) — worth a batch queue in front."""
        return True

    def call_model_batch(self, items, cancel_event=None) -> list:
        return self.store.predict_batch(
            [(item.model_id, item.payload) for item in items]
        )

    def batch_group_key(self, model_id: str) -> str:
        """Fused-dispatch grouping: co-located models of one
        layer-streamable family with identical architecture share a
        queue. Everything else batches per-model."""
        if not self.store.fused_enabled:
            return model_id
        model = self.store.get(model_id)
        if (
            model is None
            or not model.fuse_key
            or not model.batch_safe
            or model.family not in LAYER_STREAMABLE_FAMILIES
        ):
            return model_id
        return f"fuse:{model.fuse_key}"

    @property
    def requires_unload(self) -> bool:
        return True

    # -- weight streaming (the serving core's transfer subsystem) ----------

    @property
    def supports_weight_streaming(self) -> bool:
        return True

    def _export(self, model_id: str, handle: ServableModel, layers):
        """Chunk stream over ``layers`` (global leaf indices) of the
        handle's parameters, in the reference's wire format: each leaf's
        bytes in its row-major layout, ``layer`` = the leaf index, large
        leaves split at MM_TRANSFER_CHUNK_BYTES."""
        chunk_bytes = max(envs.get_int("MM_TRANSFER_CHUNK_BYTES"), 1)
        params = leaves(handle.params)
        layers = list(layers)

        def gen():
            seq = 0
            for pos, layer in enumerate(layers):
                pieces = _chunks(leaf_bytes(params[layer]), chunk_bytes)
                for j, piece in enumerate(pieces):
                    yield WeightChunk(
                        seq=seq,
                        payload=piece,
                        layer=layer,
                        last=pos == len(layers) - 1
                        and j == len(pieces) - 1,
                    )
                    seq += 1

        return gen()

    def export_weights(self, model_id: str, handle: ServableModel):
        """Chunk stream over the parameter leaves in canonical tree order.
        The receiver rebuilds tensors against the deterministic
        architecture skeleton, so no dtype/shape header is on the wire."""
        if handle is None:
            handle = self.store.get(model_id)
        if handle is None:
            return None
        return self._export(model_id, handle,
                            range(len(leaves(handle.params))))

    def _skeleton(self, model_id: str, info: ModelInfo) -> ServableModel:
        """The deterministic build, drawn where the store's models live
        (as the reference's ``build_model`` draws on its default
        device)."""
        try:
            return build_model(model_id, info.model_type, info.model_path,
                               device=self.store.device,
                               devices=self.store.devices)
        except (ValueError, NotImplementedError) as e:
            raise ModelLoadException(str(e)) from e

    def _graft(self, model_id: str, skeleton: ServableModel,
               by_layer: dict, what: str):
        """The skeleton's parameters on this store's device, with each
        leaf in ``by_layer`` replaced by its received bytes. The skeleton
        gives its parameters up (``params`` is None after), so each drawn
        leaf that a received one replaces is freed as it lands: the
        device holds the model and one leaf more at most."""
        drawn = leaves(skeleton.params)
        shape = unflatten(skeleton.params, [None] * len(drawn))
        skeleton.params = None
        out = []
        for i in range(len(drawn)):
            leaf, drawn[i] = drawn[i], None
            if i in by_layer:
                try:
                    leaf = leaf_from_bytes(b"".join(by_layer[i]), leaf)
                except ValueError as e:
                    raise ModelLoadException(
                        f"{model_id}: {what} {i}: {e} (corrupt stream)"
                    ) from e
            out.append(leaf.to(self.store.device))
        return unflatten(shape, out)

    def load_from_stream(
        self, model_id: str, info: ModelInfo, chunks, partial_ready=None,
    ) -> LoadedModel[ServableModel]:
        """Materialize from a transfer stream: receive leaf bytes, then
        graft them onto the deterministic architecture skeleton (drawn on
        the store's device). A shape/size mismatch is a corrupt or mismatched
        stream and fails the load. ``partial_ready`` is not armed: a
        model with missing layers cannot produce correct logits."""
        by_layer = _by_layer(chunks)
        skeleton = self._skeleton(model_id, info)
        n_leaves = len(leaves(skeleton.params))
        if sorted(by_layer) != list(range(n_leaves)):
            raise ModelLoadException(
                f"{model_id}: stream delivered layers {sorted(by_layer)} "
                f"but the architecture has {n_leaves} leaves"
            )
        params = self._graft(model_id, skeleton, by_layer, "layer")
        # Carry the architecture identity: a peer-streamed copy must
        # batch and fuse exactly like a store-loaded one.
        model = ServableModel(
            skeleton.apply, params, skeleton.input_shape,
            skeleton.input_dtype, family=skeleton.family,
            fuse_key=skeleton.fuse_key, batch_safe=skeleton.batch_safe,
        )
        _warm(model)
        self.store.install(model_id, model)
        return LoadedModel(handle=model, size_bytes=model.size_bytes)

    # -- sharded execution (placement groups) ------------------------------
    #
    # As the reference: a "shard" here is device-level. The whole
    # parameter set lands split across the store's serving mesh
    # (``load_sharded``), and the loader reports the shard's SHARE of the
    # bytes (ceil(total/shard_count)) as resident, which is what each
    # member of a multi-host group holds. Fleet-level slicing is what the
    # transfer path moves: a shard handle's export yields only the
    # shard's leaf range (each leaf's whole bytes), and
    # ``load_shard_from_stream`` grafts those leaves onto the
    # deterministic skeleton, which supplies the rest.

    @property
    def supports_sharded_execution(self) -> bool:
        return True

    def load_shard(
        self, model_id: str, info: ModelInfo, shard_index: int,
        shard_count: int,
    ) -> LoadedModel[ServableModel]:
        try:
            total = self.store.load_sharded(
                model_id, info.model_type, info.model_path
            )
        except Exception as e:  # noqa: BLE001
            raise ModelLoadException(f"{type(e).__name__}: {e}") from e
        handle = self.store.get(model_id)
        handle.shard_index = shard_index
        handle.shard_count = shard_count
        share = -(-total // max(shard_count, 1))
        return LoadedModel(handle=handle, size_bytes=share)

    def export_shard_weights(self, model_id: str, handle: ServableModel):
        """Chunk stream carrying ONLY this shard's leaf range (the
        contiguous leaf block from ``shard_chunk_indices`` over the leaf
        count). ``layer`` stays the GLOBAL leaf index."""
        if handle is None:
            handle = self.store.get(model_id)
        if handle is None or getattr(handle, "shard_count", 0) <= 0:
            return None
        rng = shard_chunk_indices(
            len(leaves(handle.params)), handle.shard_index,
            handle.shard_count,
        )
        return self._export(model_id, handle, rng)

    def load_shard_from_stream(
        self, model_id: str, info: ModelInfo, shard_index: int,
        shard_count: int, chunks,
    ) -> LoadedModel[ServableModel]:
        """Materialize one shard from a stream of ITS leaf range (global
        leaf indices in ``chunk.layer``); the deterministic skeleton
        supplies every other leaf."""
        by_layer = _by_layer(chunks)
        skeleton = self._skeleton(model_id, info)
        n_leaves = len(leaves(skeleton.params))
        want = set(shard_chunk_indices(n_leaves, shard_index, shard_count))
        if set(by_layer) != want:
            raise ModelLoadException(
                f"{model_id}: shard {shard_index}/{shard_count} stream "
                f"delivered leaves {sorted(by_layer)} but the shard owns "
                f"{sorted(want)}"
            )
        params = self._graft(model_id, skeleton, by_layer, "leaf")
        model = shard_servable(ServableModel(
            skeleton.apply, params, skeleton.input_shape,
            skeleton.input_dtype, family=skeleton.family,
            batch_safe=skeleton.batch_safe,
        ), mesh_mod.serving_mesh(devices=self.store.devices))
        model.shard_index = shard_index
        model.shard_count = shard_count
        _warm(model)
        self.store.install(model_id, model)
        share = -(-model.size_bytes // max(shard_count, 1))
        return LoadedModel(handle=model, size_bytes=share)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8085)
    parser.add_argument("--capacity-mb", type=int, default=256)
    parser.add_argument(
        "--uds", default="",
        help="serve on unix://<path> instead of TCP (in-pod sidecar link)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to serve from (default cuda:0; 'cpu' runs the "
             "models on the host); models span every device of its type",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    server, port, servicer = start_torch_runtime(
        args.port, args.capacity_mb << 20, uds_path=args.uds,
        device=args.device, devices="auto",
    )
    log.info("torch model runtime on %s (device %s, spanning %s)",
             args.uds or f":{port}", servicer.store.device,
             [str(d) for d in servicer.store.devices])
    server.wait_for_termination()


if __name__ == "__main__":
    main()

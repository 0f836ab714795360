"""The port's own copy of the JAX package's ``serving/main.py``
(the port imports nothing of that package); names and behaviour
are the reference's, but for the runtime, the strategy and the
device: ``--runtime torch`` (the default) serves from
``InProcessTorchLoader``, ``--strategy torch`` solves with
``TorchPlacementStrategy`` (``shadow`` scores it beside greedy), and
``--device`` takes the place of the reference's platform override:
left unset it means the first CUDA device, and a host without one
raises (``device.resolve_device``). A pod that runs neither the
torch runtime nor a torch strategy touches no device. The
reference's kernel backends (``xla``, ``pallas``) in
``MM_SOLVER_SPARSE_IMPL``/``MM_SOLVER_LSE_IMPL`` fail at startup. On
SIGTERM it waits for the background tasks' ticks in flight before it
exits.

Deployable serving-instance entrypoint.

One process = one mesh instance: KV client (remote MeshKV or etcd),
model runtime (in-process torch server, external sidecar, or the test fake),
the gRPC mesh server (management + internal + inference), background tasks,
vmodels, metrics, optional preStop hook. The equivalent of the reference's
start.sh + litelinks service bootstrap (SURVEY.md section 3.1).

    python -m modelmesh_tpu_torch.serving.main \
        --kv mesh://127.0.0.1:2379 --instance-id i-0 --port 9000 \
        --runtime torch --strategy torch --capacity-mb 512 --metrics-port 2112

Env: MM_STATIC_MODELS (JSON) for startup registration,
MM_PAYLOAD_PROCESSORS (comma-separated URIs), MM_TYPE_CONSTRAINTS (path to
watched JSON file), MM_ZONE / MM_LABELS for placement metadata.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from modelmesh_tpu_torch.utils import envs

log = logging.getLogger("modelmesh_tpu_torch.main")

# The kernel-backend knobs of the solve: the port takes auto | cuda, and
# the reference's xla | pallas fail at startup, not at the first refresh.
KERNEL_IMPL_KNOBS = ("MM_SOLVER_SPARSE_IMPL", "MM_SOLVER_LSE_IMPL")

# How long shutdown waits for each background task's tick in flight.
TASK_JOIN_S = 60.0


def build_store(kv_uri: str, tls=None):
    """mesh://host:port | etcd://host:port | zookeeper://host:port |
    memory:// (single process).

    ``tls`` secures the coordination plane too — registry records carry
    model_key credential blobs, so the KV link deserves the same mTLS as
    the data plane."""
    scheme, _, rest = kv_uri.partition("://")
    if scheme == "memory":
        from modelmesh_tpu_torch.kv.memory import InMemoryKV

        return InMemoryKV()
    if scheme == "mesh":
        from modelmesh_tpu_torch.kv.service import RemoteKV

        return RemoteKV(rest, tls=tls)
    if scheme == "etcd":
        from modelmesh_tpu_torch.kv.etcd import EtcdKV

        return EtcdKV(rest, tls=tls)
    if scheme == "zookeeper":
        from modelmesh_tpu_torch.kv.zookeeper import ZookeeperKV

        return ZookeeperKV(rest, tls=tls)
    raise ValueError(
        f"unknown kv scheme {scheme!r} "
        "(mesh://, etcd://, zookeeper://, memory://)"
    )


def build_loader(runtime: str, capacity_mb: int, tls=None, device=None):
    """``device`` is the torch runtime's (``None``: the first CUDA
    device, or ``RuntimeError`` without one); the others take none."""
    if runtime == "torch":
        from modelmesh_tpu_torch.models.server import InProcessTorchLoader

        return InProcessTorchLoader(
            capacity_bytes=capacity_mb << 20, device=device
        )
    if runtime == "fake":
        from modelmesh_tpu_torch.runtime.fake import FakeRuntimeServicer, start_fake_runtime
        from modelmesh_tpu_torch.runtime.sidecar import SidecarRuntime

        server, port, _ = start_fake_runtime(
            servicer=FakeRuntimeServicer(capacity_bytes=capacity_mb << 20)
        )
        loader = SidecarRuntime(f"127.0.0.1:{port}", startup_timeout_s=30)
        # Keep the embedded runtime server alive for the loader's lifetime.
        loader._embedded_runtime_server = server
        return loader
    if runtime.startswith("sidecar:"):
        from modelmesh_tpu_torch.runtime.sidecar import SidecarRuntime

        return SidecarRuntime(
            runtime[len("sidecar:"):], startup_timeout_s=300, tls=tls
        )
    raise ValueError(
        f"unknown runtime {runtime!r} "
        "(torch | fake | sidecar:host:port | sidecar:unix:///path.sock)"
    )


def check_kernel_knobs(device) -> None:
    """Validate ``KERNEL_IMPL_KNOBS`` against the solve's ``device``
    (``None``: a pod with no torch strategy, whose values are checked
    alone)."""
    from modelmesh_tpu_torch import device as device_mod

    for knob in KERNEL_IMPL_KNOBS:
        device_mod.resolve_kernel_impl(
            knob, envs.get(knob) or "auto",
            # A CUDA device stands in for "no solve here": it accepts
            # both auto and cuda, and touches no card.
            device if device is not None else "cuda",
        )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--kv", default=envs.get("MM_KV_URI") or "memory://"
    )
    parser.add_argument("--instance-id", default=None)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--frontdoor-port", type=int, default=-1,
        help="shared SO_REUSEPORT public port for the external surfaces; "
        "start N worker processes with the SAME value to spread one "
        "host's data plane across cores (each worker keeps its own "
        "unique --port for internal forwards)",
    )
    parser.add_argument("--advertise-host", default="127.0.0.1")
    parser.add_argument("--runtime", default="torch")
    parser.add_argument("--capacity-mb", type=int, default=256)
    parser.add_argument("--metrics-port", type=int, default=-1)
    parser.add_argument("--prestop-port", type=int, default=-1)
    parser.add_argument(
        "--strategy", choices=["greedy", "torch", "shadow"],
        default="greedy",
        help="placement decisions: greedy heuristics, the torch global "
        "plan, or shadow (serve greedy while scoring the torch plan on the "
        "side - read agreement in the ***GETSTATE*** dump before promoting)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device of the torch runtime and the torch/shadow "
        "strategies (default cuda:0, raising on a host without CUDA; "
        "'cpu' runs them on the host)",
    )
    parser.add_argument("--load-timeout-s", type=float, default=None)
    parser.add_argument("--tls-cert", default="", help="server cert PEM path")
    parser.add_argument("--tls-key", default="", help="server key PEM path")
    parser.add_argument("--tls-ca", default="", help="trust-root PEM path")
    parser.add_argument(
        "--tls-client-auth", action="store_true",
        help="require peer/client certificates signed by --tls-ca (mTLS)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=envs.get("MM_LOG_LEVEL"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s %(reqctx)s",
    )
    from modelmesh_tpu_torch.observability.logctx import install_filter

    install_filter()

    from modelmesh_tpu_torch.observability.metrics import NoopMetrics, PrometheusMetrics
    from modelmesh_tpu_torch.observability.payloads import build_processor
    from modelmesh_tpu_torch.serving.api import (
        MeshServer,
        PeerChannels,
        make_grpc_peer_call,
        make_grpc_peer_fetch,
    )
    from modelmesh_tpu_torch.serving.bootstrap import (
        PreStopServer,
        register_static_models,
    )
    from modelmesh_tpu_torch.serving.constraints import (
        ConstraintsFileWatcher,
        TypeConstraints,
        UpgradeTracker,
    )
    from modelmesh_tpu_torch.serving.instance import InstanceConfig, ModelMeshInstance
    from modelmesh_tpu_torch.serving.tasks import BackgroundTasks
    from modelmesh_tpu_torch.serving.vmodels import VModelManager

    tls = None
    if args.tls_cert:
        from modelmesh_tpu_torch.serving.tls import TlsConfig

        tls = TlsConfig.from_files(
            args.tls_cert, args.tls_key, args.tls_ca or None,
            require_client_auth=args.tls_client_auth,
        )

    # The device is resolved only where it is used: the torch runtime and
    # the torch/shadow strategies. A greedy pod over another runtime
    # touches none.
    device = None
    if args.runtime == "torch" or args.strategy in ("torch", "shadow"):
        from modelmesh_tpu_torch import device as device_mod

        device = device_mod.resolve_device(args.device)
    check_kernel_knobs(device if args.strategy != "greedy" else None)

    store = build_store(args.kv, tls=tls)
    loader = build_loader(args.runtime, args.capacity_mb, tls=tls,
                          device=device)
    metrics = (
        PrometheusMetrics(
            port=max(args.metrics_port, 0),
            instance_id=args.instance_id or "",
            per_model=envs.get_bool("MM_PER_MODEL_METRICS"),
        )
        if args.metrics_port >= 0
        else NoopMetrics()
    )
    constraints = None
    watcher = None
    constraints_path = envs.get("MM_TYPE_CONSTRAINTS") or ""
    if constraints_path:
        constraints = TypeConstraints()
        watcher = ConstraintsFileWatcher(constraints_path, constraints)

    strategy = None
    if args.strategy == "torch":
        from modelmesh_tpu_torch.placement.torch_engine import (
            TorchPlacementStrategy,
        )

        strategy = TorchPlacementStrategy(device=device)
    elif args.strategy == "shadow":
        from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
        from modelmesh_tpu_torch.placement.shadow import ShadowStrategy
        from modelmesh_tpu_torch.placement.torch_engine import (
            TorchPlacementStrategy,
        )

        # Serve greedy; score the torch plan on every decision. The shadow's
        # own fallback is greedy too, so "agreement" during plan gaps is
        # trivially high — the interesting rate is while a plan is live.
        strategy = ShadowStrategy(
            GreedyStrategy(), TorchPlacementStrategy(device=device)
        )

    from modelmesh_tpu_torch.serving.health import BootstrapProbation

    instance = ModelMeshInstance(
        store,
        loader,
        InstanceConfig(
            instance_id=args.instance_id,
            zone=envs.get("MM_ZONE") or "",
            labels=envs.get_list("MM_LABELS"),
            load_timeout_s=args.load_timeout_s,
        ),
        strategy=strategy,
        # Forward and FetchWeights share one channel cache: both internal
        # surfaces multiplex the same connection per peer.
        peer_call=make_grpc_peer_call(peer_channels := PeerChannels(tls)),
        peer_fetch=make_grpc_peer_fetch(peer_channels),
        metrics=metrics,
        constraints=constraints,
        upgrade_tracker=UpgradeTracker(),
        probation=BootstrapProbation.from_env(),
    )
    vmodels = VModelManager(instance)
    payload_proc = build_processor(envs.get_list("MM_PAYLOAD_PROCESSORS"))
    server = MeshServer(
        instance,
        port=args.port,
        vmodels=vmodels,
        advertise_host=args.advertise_host,
        payload_processor=payload_proc,
        tls=tls,
        frontdoor_port=(
            args.frontdoor_port if args.frontdoor_port >= 0 else None
        ),
    )
    instance.config.endpoint = server.endpoint
    instance.publish_instance_record(force=True)
    tasks = BackgroundTasks(instance)
    tasks.start()
    from modelmesh_tpu_torch.serving.dynamic import ServingConfigBinder

    config_binder = ServingConfigBinder(
        store, instance.config.kv_prefix, instance, tasks.config
    )
    prestop = (
        PreStopServer(instance, port=max(args.prestop_port, 0))
        if args.prestop_port >= 0
        else None
    )
    if prestop is not None:
        log.info("lifecycle http (/ready /live /prestop) on :%d", prestop.port)
    register_static_models(instance, vmodels=vmodels)
    log.info(
        "instance %s serving on %s (kv=%s runtime=%s strategy=%s)",
        instance.instance_id, server.endpoint, args.kv, args.runtime,
        args.strategy,
    )
    print(f"READY {server.endpoint}", flush=True)

    stop = threading.Event()

    def on_term(signum, frame):
        log.info("signal %d: migrating and shutting down", signum)
        try:
            instance.pre_shutdown()
        finally:
            stop.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    stop.wait()
    tasks.stop()
    # A task tick in flight (a reaper refresh on the card) ends before the
    # process goes on to exit: a daemon thread still inside a CUDA call
    # while the interpreter tears down aborts the process.
    for t in tasks._threads:
        t.join(TASK_JOIN_S)
    config_binder.close()
    vmodels.close()
    server.stop()
    if prestop is not None:
        prestop.close()
    if watcher is not None:
        watcher.close()
    instance.shutdown()
    metrics.close()
    store.close()


if __name__ == "__main__":
    main()

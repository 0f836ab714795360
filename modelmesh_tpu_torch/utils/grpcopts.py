"""Shared gRPC message-size options — the 16 MiB data plane.

The port's copy of the JAX package's ``utils/grpcopts.py``. Every hop a
payload can cross must carry messages up to the configured maximum, or
payloads die with RESOURCE_EXHAUSTED at gRPC's 4 MiB default. The cap is
``MM_MAX_MSG_BYTES`` (default 16 MiB, the reference's service cap).
"""

from __future__ import annotations


def max_message_bytes() -> int:
    from modelmesh_tpu_torch.utils.envs import get_int

    return get_int("MM_MAX_MSG_BYTES")


def message_size_options() -> list[tuple[str, int]]:
    """Channel/server options enabling the configured message cap."""
    n = max_message_bytes()
    return [
        ("grpc.max_receive_message_length", n),
        ("grpc.max_send_message_length", n),
    ]

"""The port's own copy of the JAX package's ``observability/logctx.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Per-request log context from configured request headers.

Parity with the reference's LogRequestHeaders (LogRequestHeaders.java:17-35,
wired as an MDC in its gRPC interceptor): operators name the headers whose
values should accompany every log line emitted while handling a request
(transaction ids, user ids). Config via ``MM_LOG_REQUEST_HEADERS`` — a
comma-separated list of ``header`` or ``header=log_field`` entries.

Mechanics: a contextvar holds the per-request mapping (it follows the
handler thread through nested calls), and ``LogContextFilter`` splices it
into every LogRecord as ``record.reqctx`` (rendered by including
``%(reqctx)s`` in the format string). Install with ``install_filter()``.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Iterable, Optional

_current: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "mm_log_ctx", default={}
)


class HeaderLogContext:
    """Parsed MM_LOG_REQUEST_HEADERS config + context management."""

    def __init__(self, spec: str = ""):
        # header (lowercased) -> log field name
        self.mapping: dict[str, str] = {}
        for entry in spec.replace(";", ",").split(","):
            entry = entry.strip()
            if not entry:
                continue
            header, _, field = entry.partition("=")
            self.mapping[header.strip().lower()] = (
                field.strip() or header.strip().lower()
            )

    @classmethod
    def from_env(cls) -> "HeaderLogContext":
        from modelmesh_tpu_torch.utils.envs import get

        return cls(get("MM_LOG_REQUEST_HEADERS") or "")

    def extract(self, headers: Iterable[tuple[str, str]]) -> dict:
        if not self.mapping:
            return {}
        out = {}
        for k, v in headers:
            field = self.mapping.get(k.lower())
            if field is not None and isinstance(v, str):
                out[field] = v
        return out

    @contextlib.contextmanager
    def bind(self, headers: Iterable[tuple[str, str]]):
        ctx = self.extract(headers)
        if not ctx:
            yield
            return
        token = _current.set(ctx)
        try:
            yield
        finally:
            _current.reset(token)


def current() -> dict:
    return _current.get()


class LogContextFilter(logging.Filter):
    """Injects the bound request context into every record as ``reqctx``."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _current.get()
        record.reqctx = (
            " ".join(f"{k}={v}" for k, v in ctx.items()) if ctx else ""
        )
        return True


def install_filter() -> None:
    """Attach the filter to the root logger's handlers (idempotent)."""
    root = logging.getLogger()
    for h in root.handlers:
        if not any(isinstance(f, LogContextFilter) for f in h.filters):
            h.addFilter(LogContextFilter())

"""The port's own copy of the JAX package's ``sim/tracing.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

TraceCollector: assemble cross-instance trace trees from a SimCluster.

Each pod's Tracer keeps only its own bounded ring; a distributed request
leaves one record per instance it touched (the entry pod's root, each
forward hop's record, the loading pod's load record, the weight sender's
FetchWeights records), all sharing one trace id and linked by
span_id/parent_id (observability/tracing.py). The collector gathers
every pod's ring — dead pods included, their rings survive the kill —
groups by trace id, and rebuilds the span tree for scenario assertions:
"one request, one tree, spanning N instances, with virtual timestamps".

Read-only over the tracers' rings (each ``recent()`` snapshot is taken
under that tracer's own lock); the collector itself holds no state worth
locking and is meant to be called at quiescence.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from modelmesh_tpu_torch.sim.harness import SimCluster


class SpanNode:
    """One span (or per-instance trace record root) in an assembled tree."""

    __slots__ = ("name", "span_id", "parent_id", "instance", "start_ms",
                 "duration_ms", "attrs", "children")

    def __init__(self, name: str, span_id: str, parent_id: str,
                 instance: str, start_ms: int, duration_ms: float,
                 attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.instance = instance
        self.start_ms = start_ms
        self.duration_ms = duration_ms
        self.attrs = attrs
        self.children: list[SpanNode] = []

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def render(self, indent: int = 0) -> str:
        lines = [
            "%s%s [%s] @%sms %.3fms" % (
                "  " * indent, self.name, self.instance, self.start_ms,
                self.duration_ms,
            )
        ]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)


_CORE_KEYS = ("name", "span_id", "parent_id", "instance", "start_ms",
              "duration_ms", "at_ms", "spans", "trace_id", "model_id",
              "method")


def _attrs(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in _CORE_KEYS}


class TraceCollector:
    def __init__(self, cluster: "SimCluster"):
        self.cluster = cluster

    # -- collection ---------------------------------------------------------

    def collect(self) -> dict[str, list[dict]]:
        """trace_id -> finished records from EVERY pod (dead ones too)."""
        out: dict[str, list[dict]] = {}
        for pod in self.cluster.pods:
            tracer = pod.instance.tracer
            for rec in tracer.recent(tracer.capacity):
                out.setdefault(rec["trace_id"], []).append(rec)
        return out

    def instances(self, trace_id: str) -> set[str]:
        return {
            r["instance"] for r in self.collect().get(trace_id, ())
        }

    def span_names(self, trace_id: str) -> set[str]:
        names: set[str] = set()
        for rec in self.collect().get(trace_id, ()):
            names.add(rec["method"] or rec["model_id"])
            for s in rec["spans"]:
                names.add(s["name"])
        return names

    # -- assembly -----------------------------------------------------------

    def tree(self, trace_id: str) -> Optional[SpanNode]:
        """Rebuild the single tree for ``trace_id``: every record root
        and every span becomes a node, parented by span ids (cross-
        instance links included — a forwarded hop's root parents under
        the sender's forward span). Orphans (ring-evicted parents) and
        multiple roots attach under a synthetic root so the result is
        always one walkable tree; returns None for an unknown id."""
        records = self.collect().get(trace_id)
        if not records:
            return None
        nodes: dict[str, SpanNode] = {}
        for rec in records:
            nodes[rec["span_id"]] = SpanNode(
                name=rec["method"] or "request",
                span_id=rec["span_id"], parent_id=rec["parent_id"],
                instance=rec["instance"], start_ms=rec["start_ms"],
                duration_ms=rec["duration_ms"], attrs=_attrs(rec),
            )
            for s in rec["spans"]:
                nodes[s["span_id"]] = SpanNode(
                    name=s["name"], span_id=s["span_id"],
                    parent_id=s["parent_id"], instance=s["instance"],
                    start_ms=s["start_ms"], duration_ms=s["duration_ms"],
                    attrs=_attrs(s),
                )
        roots: list[SpanNode] = []
        for node in nodes.values():
            parent = nodes.get(node.parent_id) if node.parent_id else None
            if parent is None or parent is node:
                roots.append(node)
            else:
                parent.children.append(node)
        for node in nodes.values():
            node.children.sort(key=lambda n: (n.start_ms, n.span_id))
        if len(roots) == 1:
            return roots[0]
        roots.sort(key=lambda n: (n.start_ms, n.span_id))
        synthetic = SpanNode(
            name="trace", span_id=trace_id, parent_id="", instance="",
            start_ms=roots[0].start_ms if roots else 0, duration_ms=0.0,
            attrs={},
        )
        synthetic.children = roots
        return synthetic

    def depth(self, trace_id: str) -> int:
        root = self.tree(trace_id)
        if root is None:
            return 0

        def d(node: SpanNode) -> int:
            return 1 + max((d(c) for c in node.children), default=0)

        return d(root)

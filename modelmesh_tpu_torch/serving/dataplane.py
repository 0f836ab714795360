"""The port's own copy of the JAX package's ``serving/dataplane.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Dataplane API configuration: inference-RPC allow-list + id extraction.

Parity with the reference's DataplaneApiConfig (DataplaneApiConfig.java:
51-119): JSON declaring which arbitrary inference RPCs are permitted and,
per RPC, where in the request protobuf the model id lives (so clients that
put the id in the message body instead of metadata still route), plus
whether that id is a vmodel.

{
  "rpcs": {
    "/pkg.Service/Predict": {"idExtractionPath": [1, 2], "vmodel": false},
    "/pkg.Service/Admin": {"allowed": false}
  },
  "allowOtherRpcs": true
}
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class RpcConfig:
    allowed: bool = True
    id_extraction_path: tuple[int, ...] = ()
    vmodel: bool = False


class DataplaneApiConfig:
    def __init__(self, rpcs: Optional[dict[str, RpcConfig]] = None,
                 allow_other_rpcs: bool = True):
        self.rpcs = rpcs or {}
        self.allow_other_rpcs = allow_other_rpcs

    @classmethod
    def from_json(cls, text: str) -> "DataplaneApiConfig":
        cfg = json.loads(text) if text.strip() else {}
        rpcs = {}
        for method, spec in (cfg.get("rpcs") or {}).items():
            rpcs[method] = RpcConfig(
                allowed=spec.get("allowed", True),
                id_extraction_path=tuple(spec.get("idExtractionPath", ())),
                vmodel=spec.get("vmodel", False),
            )
        return cls(rpcs, cfg.get("allowOtherRpcs", True))

    def rpc(self, method: str) -> Optional[RpcConfig]:
        c = self.rpcs.get(method)
        if c is not None:
            return c
        return RpcConfig() if self.allow_other_rpcs else None

    def is_allowed(self, method: str) -> bool:
        c = self.rpc(method)
        return c is not None and c.allowed

    def extraction_path(self, method: str) -> tuple[int, ...]:
        c = self.rpc(method)
        return c.id_extraction_path if c else ()

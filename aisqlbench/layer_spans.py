"""The program's per-layer spans inside a batcher step's ``step.forward``
(``layer.attn``, ``layer.ffn``: ``repro_torch.obs.engine.layer``), as the
readers of the per-layer roofline shares take them."""
from __future__ import annotations

from typing import Dict, List, Optional

from aisqlbench import spans


def layers(step: Dict, kind: str) -> Optional[List[Dict]]:
    """The ``kind`` layer spans of a step, in order, or None where it has
    none or any lacks its ``device_ms`` (the CPU)."""
    fwd = spans.phase(step, "step.forward")
    out = [c for c in (fwd["children"] if fwd else ()) if c["kind"] == kind]
    if not out or any("device_ms" not in c["attrs"] for c in out):
        return None
    return out

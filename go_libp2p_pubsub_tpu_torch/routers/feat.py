"""Protocol feature negotiation (gossipsub_feat.go).

Feature tests keyed by protocol ID: Mesh (v1.0 + v1.1), PX (v1.1 only).
"""

from __future__ import annotations

import enum
from typing import Callable

GOSSIPSUB_ID_V10 = "/meshsub/1.0.0"
GOSSIPSUB_ID_V11 = "/meshsub/1.1.0"


class GossipSubFeature(enum.Enum):
    MESH = 1  # GRAFT/PRUNE control (gossipsub_feat.go:14-20)
    PX = 2    # peer exchange on prune (v1.1 only)


def default_features(feat: GossipSubFeature, proto: str) -> bool:
    """gossipsub_feat.go:24-36."""
    if feat == GossipSubFeature.MESH:
        return proto in (GOSSIPSUB_ID_V10, GOSSIPSUB_ID_V11)
    if feat == GossipSubFeature.PX:
        return proto == GOSSIPSUB_ID_V11
    return False


GossipSubFeatureTest = Callable[[GossipSubFeature, str], bool]

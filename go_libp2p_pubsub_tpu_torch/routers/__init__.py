"""The per-node routers of the functional runtime (port of routers/):
floodsub, randomsub, gossipsub v1.1 with its score, promise, tag and
gater tracers."""

from .base import Router  # noqa: F401
from .feat import (  # noqa: F401
    GOSSIPSUB_ID_V10,
    GOSSIPSUB_ID_V11,
    GossipSubFeature,
    default_features,
)
from .floodsub import FLOODSUB_ID, FloodSubRouter  # noqa: F401
from .gossip_tracer import GossipPromiseTracker  # noqa: F401
from .gossipsub import GossipSubRouter  # noqa: F401
from .peer_gater import PeerGater, PeerGaterParams  # noqa: F401
from .randomsub import RANDOMSUB_ID, RandomSubRouter  # noqa: F401
from .score import PeerScore  # noqa: F401
from .tag_tracer import TagTracer  # noqa: F401

"""Host-side helpers of the functional runtime (port of utils/): seen
caches, message ids, the gossip message cache, backoff, blacklists and
subscription filters."""

from .backoff import Backoff, MaxBackoffAttemptsError  # noqa: F401
from .blacklist import Blacklist, MapBlacklist, TimeCachedBlacklist  # noqa: F401
from .mcache import MessageCache  # noqa: F401
from .midgen import MsgIdGenerator, default_msg_id_fn  # noqa: F401
from .subscription_filter import (  # noqa: F401
    AllowlistSubscriptionFilter,
    LimitSubscriptionFilter,
    RegexpSubscriptionFilter,
    SubscriptionFilter,
    TooManySubscriptionsError,
    filter_subscriptions,
)
from .timecache import SWEEP_INTERVAL, Strategy, TimeCache  # noqa: F401

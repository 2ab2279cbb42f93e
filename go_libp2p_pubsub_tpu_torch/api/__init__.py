"""The application API of the functional runtime (port of api/): PubSub,
topics, subscriptions, signing, validation, discovery and peer records."""

from .pubsub import PubSub  # noqa: F401
from .sign import (  # noqa: F401
    LAX_NO_SIGN,
    LAX_SIGN,
    STRICT_NO_SIGN,
    STRICT_SIGN,
    SignError,
    SignPolicy,
    generate_keypair,
    sign_message,
    verify_message_signature,
)
from .subscription import Subscription  # noqa: F401
from .topic import PeerEvent, Topic, TopicEventHandler  # noqa: F401
from .validation import (  # noqa: F401
    VALIDATION_ACCEPT,
    VALIDATION_IGNORE,
    VALIDATION_REJECT,
    Validation,
    ValidationError,
)

"""The simulated network substrate of the functional runtime (port of
net/): hosts, a discrete-event scheduler and a connection manager."""

from .network import Host, Network, Notifiee, Scheduler  # noqa: F401

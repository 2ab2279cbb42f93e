"""The pubsub wire codec's TraceEvent half (port of pb/)."""

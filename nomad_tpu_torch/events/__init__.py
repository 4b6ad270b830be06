"""Cluster event stream (ref nomad/stream/: the Nomad 1.0 event broker
behind /v1/event/stream). FSM-sourced typed events in a bounded ring
buffer, fanned out through encode-once frames to per-subscriber queues
with topic/key filters; cold subscribers can start from a state snapshot
stamped at raft index N (snapshot-on-subscribe) and ride deltas from N.
``mux.py`` hosts the shared-socket fan-out pump the chunked HTTP tier
scales on."""

from .broker import (
    ALL_TOPICS,
    TOPIC_ALL,
    TOPIC_ALLOC,
    TOPIC_DEPLOYMENT,
    TOPIC_EVAL,
    TOPIC_JOB,
    TOPIC_NODE,
    TOPIC_NODE_EVENT,
    TOPIC_PLAN_RESULT,
    BrokerLimitError,
    Event,
    EventBroker,
    Frame,
    Subscription,
    SubscriptionClosedError,
    encode_event,
    event_visible,
    event_wire,
    required_capability,
)

__all__ = [
    "ALL_TOPICS",
    "TOPIC_ALL",
    "TOPIC_ALLOC",
    "TOPIC_DEPLOYMENT",
    "TOPIC_EVAL",
    "TOPIC_JOB",
    "TOPIC_NODE",
    "TOPIC_NODE_EVENT",
    "TOPIC_PLAN_RESULT",
    "BrokerLimitError",
    "Event",
    "EventBroker",
    "Frame",
    "Subscription",
    "SubscriptionClosedError",
    "encode_event",
    "event_visible",
    "event_wire",
    "required_capability",
]

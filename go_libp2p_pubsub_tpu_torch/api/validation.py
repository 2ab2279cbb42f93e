"""Validation pipeline (validation.go).

Queue caps and throttles are preserved as *counters* on the deterministic
scheduler instead of goroutines/channels:

- front-end queue: ``validate_queue_size`` pending requests; overflow drops
  with RejectValidationQueueFull (validation.go:246-260)
- sync workers: requests drain from the queue after ``worker_delay`` virtual
  seconds (the off-loop hop the reference gets from its NumCPU workers)
- async validators: bounded by the global throttle (8192) and per-validator
  throttle (1024); overflow -> RejectValidationThrottled / peer throttled
  (validation.go:344-370, 459-500)
- the signature check -> mark-seen -> inline validators -> async validators
  ordering matches validation.go:293-370
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from ..core.params import (
    DEFAULT_VALIDATE_CONCURRENCY,
    DEFAULT_VALIDATE_QUEUE_SIZE,
    DEFAULT_VALIDATE_THROTTLE,
)
from ..core.types import Message, PeerID
from ..trace import events as ev
from .sign import SignError, verify_message_signature

if TYPE_CHECKING:
    from .pubsub import PubSub

# ValidationResult (validation.go:36-52)
VALIDATION_ACCEPT = 0
VALIDATION_REJECT = 1
VALIDATION_IGNORE = 2

ValidatorEx = Callable[[PeerID, Message], int]


class ValidationError(ValueError):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class ValidatorImpl:
    def __init__(self, topic: str, validate: ValidatorEx, throttle: int,
                 inline: bool, timeout: float = 0.0):
        self.topic = topic
        self.validate = validate
        self.throttle = throttle
        self.inflight = 0
        self.inline = inline
        # WithValidatorTimeout (validation.go:564-570): deadline for the
        # async leg, in virtual seconds; 0 = none
        self.timeout = timeout


def as_validator_ex(fn) -> ValidatorEx:
    """Accept bool-returning Validator or enum ValidatorEx (validation.go:163-192)."""
    def wrapped(src: PeerID, msg: Message) -> int:
        r = fn(src, msg)
        if isinstance(r, bool):
            return VALIDATION_ACCEPT if r else VALIDATION_REJECT
        return int(r)
    # a validator may model its execution time on the virtual clock; the
    # async leg uses it for deadline (timeout) semantics
    wrapped.virtual_duration = getattr(fn, "virtual_duration", 0.0)
    return wrapped


class Validation:
    def __init__(self, queue_size: int = DEFAULT_VALIDATE_QUEUE_SIZE,
                 throttle: int = DEFAULT_VALIDATE_THROTTLE,
                 worker_delay: float = 0.0):
        self.p: "PubSub | None" = None
        self.topic_vals: dict[str, ValidatorImpl] = {}
        self.default_vals: list[ValidatorImpl] = []
        self.queue_size = queue_size
        self.queued = 0
        self.throttle_cap = throttle
        self.throttled = 0
        self.worker_delay = worker_delay

    def start(self, p: "PubSub") -> None:
        self.p = p

    # -- registration (validation.go:140-226) --

    def add_validator(self, topic: str, validate, throttle: int = 0,
                      inline: bool = False, timeout: float = 0.0) -> None:
        if topic in self.topic_vals:
            raise ValueError(f"duplicate validator for topic {topic}")
        self.topic_vals[topic] = ValidatorImpl(
            topic, as_validator_ex(validate),
            throttle or DEFAULT_VALIDATE_CONCURRENCY, inline, timeout)

    def add_default_validator(self, validate, inline: bool = False,
                              timeout: float = 0.0) -> None:
        self.default_vals.append(ValidatorImpl(
            "", as_validator_ex(validate), DEFAULT_VALIDATE_CONCURRENCY,
            inline, timeout))

    @staticmethod
    def _run_validator(v: ValidatorImpl, src: PeerID | None,
                       msg: Message) -> tuple[int, float]:
        """validateMsg (validation.go:473-497): run one validator under its
        deadline. A validator models its execution time on the virtual clock
        via a ``virtual_duration`` attribute; exceeding ``timeout`` means
        the context expires and the verdict is IGNORE (the reference's
        ctx-respecting validators return ignore on deadline). Returns
        (result, virtual seconds consumed)."""
        dur = getattr(v.validate, "virtual_duration", 0.0)
        if v.timeout > 0 and dur > v.timeout:
            return VALIDATION_IGNORE, v.timeout
        return v.validate(src, msg), dur

    def remove_validator(self, topic: str) -> None:
        if topic not in self.topic_vals:
            raise ValueError(f"no validator for topic {topic}")
        del self.topic_vals[topic]

    def get_validators(self, msg: Message) -> list[ValidatorImpl]:
        vals = list(self.default_vals)
        v = self.topic_vals.get(msg.topic)
        return vals + [v] if v is not None else vals

    # -- entry points --

    def push_local(self, msg: Message) -> None:
        """Synchronous local-publish path (validation.go:232-242).
        Raises ValidationError on rejection."""
        p = self.p
        assert p is not None
        p.tracer.publish_message(msg)
        p.check_signing_policy(msg)  # raises on policy violation
        self._validate(self.get_validators(msg), msg.received_from, msg,
                       synchronous=True)

    def push(self, src: PeerID, msg: Message) -> bool:
        """Inbound path; True means forward immediately, no validation needed
        (validation.go:246-260)."""
        p = self.p
        assert p is not None
        vals = self.get_validators(msg)
        if vals or msg.signature is not None:
            if self.queued >= self.queue_size:
                p.tracer.reject_message(msg, ev.REJECT_VALIDATION_QUEUE_FULL)
                return False
            self.queued += 1

            def worker():
                self.queued -= 1
                try:
                    self._validate(vals, src, msg, synchronous=False)
                except ValidationError:
                    pass

            if self.worker_delay > 0:
                p.scheduler.call_later(self.worker_delay, worker)
            else:
                worker()
            return False
        return True

    # -- the pipeline (validation.go:293-370) --

    def _validate(self, vals: list[ValidatorImpl], src: PeerID | None,
                  msg: Message, synchronous: bool) -> None:
        p = self.p
        assert p is not None
        if msg.signature is not None:
            try:
                verify_message_signature(msg)
            except SignError:
                p.tracer.reject_message(msg, ev.REJECT_INVALID_SIGNATURE)
                raise ValidationError(ev.REJECT_INVALID_SIGNATURE) from None

        # mark seen after signature verification, before user validators
        mid = p.id_gen.id(msg)
        if not p.mark_seen(mid):
            p.tracer.duplicate_message(msg)
            return
        p.tracer.validate_message(msg)

        inline = [v for v in vals if v.inline or synchronous]
        async_vals = [v for v in vals if not (v.inline or synchronous)]

        result = VALIDATION_ACCEPT
        for v in inline:
            # deadline applies to the inline leg too: the reference's
            # inline loop also calls validateMsg (validation.go:326-327);
            # the caller stays synchronous, only the verdict reflects it
            r, _ = self._run_validator(v, src, msg)
            if r == VALIDATION_REJECT:
                p.tracer.reject_message(msg, ev.REJECT_VALIDATION_FAILED)
                raise ValidationError(ev.REJECT_VALIDATION_FAILED)
            if r == VALIDATION_IGNORE:
                result = VALIDATION_IGNORE

        if async_vals:
            if self.throttled >= self.throttle_cap:
                p.tracer.reject_message(msg, ev.REJECT_VALIDATION_THROTTLED)
                return
            # the global throttle slot is held until the async leg's verdict
            # lands (the reference's validation goroutine lifetime); with
            # slow validators that is `elapsed` virtual seconds later
            self.throttled += 1
            self._do_validate_topic(async_vals, src, msg, result)
            return

        if result == VALIDATION_IGNORE:
            p.tracer.reject_message(msg, ev.REJECT_VALIDATION_IGNORED)
            raise ValidationError(ev.REJECT_VALIDATION_IGNORED)

        p.deliver_validated(msg)

    def _do_validate_topic(self, vals: list[ValidatorImpl], src: PeerID | None,
                           msg: Message, prior: int) -> None:
        """Async leg (validation.go:410-500) with per-validator throttles
        and deadlines. Validators with a nonzero virtual duration hold their
        throttle slot and defer the verdict until that much virtual time
        elapses (the reference's validator goroutine blocking on a slow
        validate call); a validator over its timeout contributes only the
        timeout and yields IGNORE (validateMsg ctx deadline,
        validation.go:479-483)."""
        p = self.p
        assert p is not None
        result = prior
        elapsed = 0.0
        acquired: list[ValidatorImpl] = []
        try:
            for v in vals:
                if v.inflight >= v.throttle:
                    for a in acquired:
                        a.inflight -= 1
                    self.throttled -= 1
                    p.tracer.reject_message(msg, ev.REJECT_VALIDATION_THROTTLED)
                    p.tracer.throttle_peer(src)
                    return
                v.inflight += 1
                acquired.append(v)
                r, dur = self._run_validator(v, src, msg)
                # validators run CONCURRENTLY in the reference (one
                # goroutine each, validation.go:428-456): latency is the
                # max of their durations, not the sum
                elapsed = max(elapsed, dur)
                if r == VALIDATION_REJECT:
                    result = VALIDATION_REJECT
                    break
                if r == VALIDATION_IGNORE:
                    result = VALIDATION_IGNORE
        except BaseException:
            # a raising user validator must not leak throttle slots
            for a in acquired:
                a.inflight -= 1
            self.throttled -= 1
            raise

        def finish():
            for a in acquired:
                a.inflight -= 1
            self.throttled -= 1
            if result == VALIDATION_REJECT:
                p.tracer.reject_message(msg, ev.REJECT_VALIDATION_FAILED)
                return
            if result == VALIDATION_IGNORE:
                p.tracer.reject_message(msg, ev.REJECT_VALIDATION_IGNORED)
                return
            p.deliver_validated(msg)

        if elapsed > 0:
            p.scheduler.call_later(elapsed, finish)
        else:
            finish()

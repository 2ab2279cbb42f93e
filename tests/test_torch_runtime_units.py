"""Parity of the port's runtime helpers with the JAX package's, one unit at
a time, on the CPU.

- Seeded operation sequences: the same ``random.Random(seed)`` stream of
  calls goes to a unit of each package, and the two transcripts (every
  return value, every raised error's type and text, the unit's state
  after) are equal. Units: ``utils/`` (timecache under both strategies,
  midgen, mcache, backoff, both blacklists, the three subscription
  filters), ``api/seqno_validator``, ``routers/peer_gater``,
  ``routers/tag_tracer`` with ``net/connmgr``'s decaying tags on the
  scheduler, ``api/discovery``'s ``NetworkDiscovery``, and ``api/sign``
  with ``api/peer_record`` (keys, signatures and sealed envelopes byte for
  byte, each package verifying the other's; skipped without the
  optional ``cryptography`` package).
- The reference's own unit tests of the same modules
  (tests/test_subsystems.py's peer gater, tag tracer, discovery and seqno
  classes, tests/test_score.py, tests/test_score_golden.py's
  ``TestFunctionalGolden`` with its golden constants, and
  tests/test_px_records.py) run against both packages through
  tests/test_torch_runtime.py's differential: their assertions hold on
  the port's ``routers/score.py`` and the swarms they build match.
"""

from __future__ import annotations

import random

import pytest

from test_torch_runtime import (HAVE_CRYPTO, PORT, REF, M,
                                check_differential, collect_cases, plain)

needs_crypto = pytest.mark.skipif(
    not HAVE_CRYPTO,
    reason="needs the optional 'cryptography' package (ed25519)")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _outcome(fn, *args):
    """A call's result as plain data, or its error's type name and text."""
    try:
        return plain(fn(*args))
    except Exception as e:  # the error itself is part of the transcript
        return ("raised", type(e).__name__, str(e))


def _msg(pkg, r: random.Random, topics=("a", "b", "c")):
    Message = M(pkg, "core.types").Message
    return Message(from_peer=f"peer-{r.randrange(6)}",
                   data=bytes(r.randrange(256) for _ in range(r.randrange(4))),
                   seqno=r.randrange(1 << 16).to_bytes(8, "big"),
                   topic=r.choice(topics),
                   received_from=r.choice([None, f"peer-{r.randrange(6)}"]))


# --- operation sequences ----------------------------------------------------

def seq_timecache(pkg, r):
    tc = M(pkg, "utils.timecache")
    clock = Clock()
    out = []
    for strategy in (tc.Strategy.FIRST_SEEN, tc.Strategy.LAST_SEEN):
        cache = tc.TimeCache(r.choice([5.0, 30.0, 120.0]), clock, strategy)
        for _ in range(200):
            op = r.randrange(5)
            key = f"k{r.randrange(12)}"
            if op == 0:
                out.append(("add", key, cache.add(key)))
            elif op == 1:
                out.append(("has", key, cache.has(key)))
            elif op == 2:
                cache.sweep()
                out.append(("len", len(cache)))
            elif op == 3:
                clock.t += r.choice([0.5, 3.0, 20.0, 61.0])
            else:
                out.append(("state", sorted(cache._m.items())))
        cache.done()
        out.append(len(cache))
    return out


def seq_midgen(pkg, r):
    mg = M(pkg, "utils.midgen")
    gen = mg.MsgIdGenerator()
    gen.set("b", lambda m: "B:" + m.data.hex())
    out = []
    for _ in range(100):
        m = _msg(pkg, r)
        out.append((mg.default_msg_id_fn(m), gen.raw_id(m), gen.id(m),
                    gen.id(m), m._id))
    return out


def seq_mcache(pkg, r):
    mc = M(pkg, "utils.mcache")
    out = [_outcome(mc.MessageCache, 4, 3)]
    cache = mc.MessageCache(3, 5)
    mids = []
    for _ in range(300):
        op = r.randrange(6)
        if op <= 1:
            m = _msg(pkg, r)
            cache.put(m)
            mids.append(cache._msg_id(m))
        elif op == 2 and mids:
            out.append(("get", plain(cache.get(r.choice(mids)))))
        elif op == 3 and mids:
            out.append(("tx", plain(cache.get_for_peer(
                r.choice(mids), f"peer-{r.randrange(4)}"))))
        elif op == 4:
            out.append(("ids", cache.get_gossip_ids(r.choice("abc"))))
        else:
            cache.shift()
    return out


def seq_backoff(pkg, r):
    bo = M(pkg, "utils.backoff")
    clock = Clock()
    backoff = bo.Backoff(clock, random.Random(r.randrange(1 << 30)),
                         max_attempts=r.choice([3, 4, 8]))
    out = []
    for _ in range(200):
        op = r.randrange(4)
        if op <= 1:
            out.append(_outcome(backoff.update_and_get, f"p{r.randrange(5)}"))
        elif op == 2:
            clock.t += r.choice([0.05, 1.0, 30.0, 700.0])
        else:
            backoff.cleanup()
            out.append(("len", len(backoff)))
    return out


def seq_blacklist(pkg, r):
    bl = M(pkg, "utils.blacklist")
    clock = Clock()
    lists = [bl.MapBlacklist(), bl.TimeCachedBlacklist(10.0, clock)]
    out = []
    for _ in range(200):
        op = r.randrange(4)
        peer = f"p{r.randrange(8)}"
        b = r.choice(lists)
        if op == 0:
            out.append(("add", b.add(peer)))
        elif op == 1:
            out.append(("has", b.contains(peer)))
        elif op == 2:
            clock.t += r.choice([1.0, 6.0, 11.0])
        else:
            lists[1].sweep()
    return out


def seq_subscription_filter(pkg, r):
    sf = M(pkg, "utils.subscription_filter")
    SubOpts = M(pkg, "core.types").SubOpts
    topics = ["a", "b", "news-1", "news-22", "x"]
    filters = [sf.AllowlistSubscriptionFilter("a", "news-1"),
               sf.RegexpSubscriptionFilter(r"^news-\d+$"),
               sf.LimitSubscriptionFilter(
                   sf.AllowlistSubscriptionFilter(*topics[:3]), 4)]
    out = []
    for _ in range(100):
        f = r.choice(filters)
        subs = [SubOpts(r.random() < 0.6, r.choice(topics))
                for _ in range(r.randrange(7))]
        t = r.choice(topics)
        out.append((f.can_subscribe(t),
                    _outcome(f.filter_incoming_subscriptions, "peer-1", subs),
                    plain(sf.filter_subscriptions(subs, lambda s: s != "x"))))
    return out


def seq_seqno_validator(pkg, r):
    v = M(pkg, "api.seqno_validator").BasicSeqnoValidator()
    Message = M(pkg, "core.types").Message
    out = []
    for _ in range(200):
        m = Message(from_peer=r.choice(["a", "b", None]),
                    seqno=r.choice([None, r.randrange(40).to_bytes(8, "big")]),
                    topic="t")
        out.append(v("src", m))
    out.append(sorted(v.meta._m.items()))
    return out


def seq_peer_gater(pkg, r):
    pg = M(pkg, "routers.peer_gater")
    ev = M(pkg, "trace.events")
    reasons = [ev.REJECT_VALIDATION_QUEUE_FULL, ev.REJECT_VALIDATION_THROTTLED,
               ev.REJECT_VALIDATION_IGNORED, ev.REJECT_VALIDATION_FAILED,
               ev.REJECT_INVALID_SIGNATURE]
    out = [_outcome(pg.PeerGaterParams(threshold=0).validate),
           _outcome(pg.PeerGaterParams(ignore_weight=0.5).validate)]
    clock = Clock()
    ips = {f"peer-{i}": f"10.0.0.{i % 3}" for i in range(6)}
    gater = pg.PeerGater(pg.PeerGaterParams(
        quiet=5.0, topic_delivery_weights={"a": 0.5, "b": 2.0}),
        get_ip=ips.get, rng=random.Random(r.randrange(1 << 30)))
    gater._now = clock
    for _ in range(400):
        op = r.randrange(9)
        peer = f"peer-{r.randrange(6)}"
        m = _msg(pkg, r)
        m.received_from = peer
        if op == 0:
            gater.add_peer(peer, "/meshsub/1.1.0")
        elif op == 1:
            gater.remove_peer(peer)
        elif op == 2:
            gater.validate_message(m)
        elif op == 3:
            gater.deliver_message(m)
        elif op == 4:
            gater.reject_message(m, r.choice(reasons))
        elif op == 5:
            gater.duplicate_message(m)
        elif op == 6:
            gater.decay_stats()
        elif op == 7:
            clock.t += r.choice([0.5, 2.0, 7.0])
        out.append(plain(gater.accept_from(peer)))
    out.append((gater.validate, gater.throttle, gater.last_throttle,
                sorted((ip, st.connected, st.expire, st.deliver,
                        st.duplicate, st.ignore, st.reject)
                       for ip, st in gater.ip_stats.items()),
                sorted(gater.peer_stats)))
    return out


def seq_tag_tracer(pkg, r):
    net = M(pkg, "net.network")
    tt = M(pkg, "routers.tag_tracer")
    ev = M(pkg, "trace.events")
    sched = net.Scheduler()
    cmgr = M(pkg, "net.connmgr").ConnManager(sched)
    tracer = tt.TagTracer(cmgr, direct={"peer-0"})
    reasons = [ev.REJECT_VALIDATION_THROTTLED, ev.REJECT_VALIDATION_IGNORED,
               ev.REJECT_VALIDATION_FAILED, ev.REJECT_INVALID_SIGNATURE]
    out = []
    for _ in range(400):
        op = r.randrange(10)
        peer = f"peer-{r.randrange(5)}"
        m = _msg(pkg, r, topics=("a", "b"))
        if op == 0:
            tracer.add_peer(peer, "/meshsub/1.1.0")
        elif op == 1:
            tracer.join(r.choice("ab"))
        elif op == 2:
            tracer.leave(r.choice("ab"))
        elif op == 3:
            tracer.graft(peer, r.choice("ab"))
        elif op == 4:
            tracer.prune(peer, r.choice("ab"))
        elif op == 5:
            tracer.validate_message(m)
        elif op == 6:
            tracer.duplicate_message(m)
        elif op == 7:
            tracer.deliver_message(m)
        elif op == 8:
            tracer.reject_message(m, r.choice(reasons))
        else:
            sched.run_for(r.choice([60.0, 600.0, 1800.0]))
        out.append((plain(cmgr.protections),
                    [(name, plain(tag.values))
                     for name, tag in cmgr.tags.items()],
                    plain(tracer.near_first),
                    cmgr.is_protected(peer), cmgr.is_protected(peer, "x")))
    return out


def seq_discovery(pkg, r):
    disc = M(pkg, "api.discovery")
    clock = Clock()
    nd = disc.NetworkDiscovery(ttl=r.choice([5.0, 20.0]),
                               rng=random.Random(r.randrange(1 << 30)))
    nd.bind(clock)
    out = []
    for _ in range(200):
        op = r.randrange(3)
        ns = disc.namespace(r.choice("ab"))
        if op == 0:
            out.append(nd.advertise(ns, f"peer-{r.randrange(8)}"))
        elif op == 1:
            out.append(nd.find_peers(ns, r.choice([0, 1, 3])))
        else:
            clock.t += r.choice([1.0, 4.0, 9.0])
    return out


def seq_sign(pkg, r):
    sign = M(pkg, "api.sign")
    rec = M(pkg, "api.peer_record")
    Message = M(pkg, "core.types").Message
    out = []
    for _ in range(8):
        key, pid = sign.generate_keypair(bytes(r.randrange(256)
                                               for _ in range(32)))
        m = Message(from_peer=pid, data=b"d%d" % r.randrange(99),
                    seqno=r.randrange(1 << 20).to_bytes(8, "big"), topic="t")
        sign.sign_message(pid, key, m)
        out.append((pid, sign.signable_bytes(m), m.signature, m.key,
                    _outcome(sign.verify_message_signature, m)))
        m.data += b"!"
        out.append(_outcome(sign.verify_message_signature, m))
        pr = rec.PeerRecord(peer_id=pid, seq=r.randrange(1, 99),
                            addrs=(f"10.0.0.{r.randrange(9)}",))
        env = rec.seal_record(pr, key)
        out.append((rec.encode_peer_record(pr), env,
                    plain(rec.consume_peer_record(env)),
                    plain(rec.decode_peer_record(rec.encode_peer_record(pr)))))
        bad = bytearray(env)
        bad[r.randrange(len(bad))] ^= 0x40
        out.append(_outcome(rec.consume_peer_record, bytes(bad)))
    out.append(_outcome(sign.sign_message, "peer-1", None, Message(topic="t")))
    return out


SEQUENCES = {
    "timecache": seq_timecache, "midgen": seq_midgen, "mcache": seq_mcache,
    "backoff": seq_backoff, "blacklist": seq_blacklist,
    "subscription_filter": seq_subscription_filter,
    "seqno_validator": seq_seqno_validator, "peer_gater": seq_peer_gater,
    "tag_tracer": seq_tag_tracer, "discovery": seq_discovery,
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("unit", sorted(SEQUENCES))
def test_operation_sequence_matches_reference(unit, seed):
    want = SEQUENCES[unit](REF, random.Random(seed))
    got = SEQUENCES[unit](PORT, random.Random(seed))
    assert got == want


@needs_crypto
@pytest.mark.parametrize("seed", [0, 1])
def test_sign_and_peer_record_match_reference(seed):
    want = seq_sign(REF, random.Random(seed))
    got = seq_sign(PORT, random.Random(seed))
    assert got == want


@needs_crypto
def test_each_package_verifies_the_other_s_signatures():
    jsign, sign = M(REF, "api.sign"), M(PORT, "api.sign")
    jrec, rec = M(REF, "api.peer_record"), M(PORT, "api.peer_record")
    for pkg_from, s_from, r_from, s_to, r_to, Msg in (
            (REF, jsign, jrec, sign, rec, M(PORT, "core.types").Message),
            (PORT, sign, rec, jsign, jrec, M(REF, "core.types").Message)):
        key, pid = s_from.generate_keypair(b"\x07" * 32)
        m = M(pkg_from, "core.types").Message(
            from_peer=pid, data=b"x", seqno=b"\x00" * 8, topic="t")
        s_from.sign_message(pid, key, m)
        other = Msg(from_peer=m.from_peer, data=m.data, seqno=m.seqno,
                    topic=m.topic, signature=m.signature, key=m.key)
        s_to.verify_message_signature(other)
        env = r_from.seal_record(r_from.PeerRecord(peer_id=pid, seq=3,
                                                   addrs=("1.2.3.4",)), key)
        assert r_to.consume_peer_record(env).peer_id == pid


def test_optional_crypto_flags_agree():
    for mod in ("api.sign", "api.peer_record"):
        a, b = M(REF, mod), M(PORT, mod)
        flag = "HAVE_CRYPTOGRAPHY" if hasattr(a, "HAVE_CRYPTOGRAPHY") \
            else "_HAVE_CRYPTOGRAPHY"
        assert getattr(b, flag) == getattr(a, flag) == HAVE_CRYPTO


# --- the reference's unit tests of the same modules, on both packages -------

UNIT_CASES = (
    collect_cases("test_subsystems", classes=(
        "TestPeerGater", "TestTagTracer", "TestDiscovery",
        "TestSeqnoValidator"))
    + collect_cases("test_score")
    + collect_cases("test_score_golden", classes=("TestFunctionalGolden",))
    + collect_cases("test_px_records", crypto=(
        "TestEnvelope", "TestPXDialGate", "TestPruneAttachesRecords")))


@pytest.mark.parametrize("name,cls,fn", UNIT_CASES)
def test_reference_unit_test_holds_on_both(name, cls, fn):
    check_differential(name, cls, fn)

"""Wide message windows and int32 hop counts in the port, on the CPU.

The fused hop, IWANT-resolve and emit kernels hold W = ceil(msg_window / 32)
<= 8 packed words per row in registers, and the resolve puts one receiver's
(2T+1) * K uint8 counts in a 32 KB tile. The resolvers
(ops/hopkernel.resolve_hop_mode / resolve_emit_mode) send every other shape
to the non-fused data path, from the config alone, so the CPU runs the
formulation the card runs; the wrappers refuse the same shapes from the
same constants. A window above 255 messages needs ``count_dtype="int32"``
(the uint8 accumulators would wrap), which the non-fused path carries.

The trajectories compare every SimState field exactly against the JAX
package's ``engine.run`` on the same seed; the JAX side runs the non-fused
``hop_mode="xla"`` (its two formulations are bit-identical) with its Pallas
gathers in interpret mode."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu.sim.engine import run as jrun
from go_libp2p_pubsub_tpu_torch import rng
from go_libp2p_pubsub_tpu_torch.ops import cudalib
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.sim import (SimConfig, TopicParams,
                                            build_headline, run, scenarios,
                                            state_from_reference,
                                            state_to_numpy, step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes; see
    tests/test_torch_engine_modes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (T, K): the headline's, and (2T+1) * K at and just above the 32768 counts
# of the resolve's tile
TK = [(1, 32), (1, 10922), (1, 10923), (128, 128)]


def _cfg(w, hop_mode, t, k):
    return SimConfig(n_peers=64, k_slots=k, n_topics=t, msg_window=32 * w,
                     hop_mode=hop_mode)


@pytest.mark.parametrize("t,k", TK)
@pytest.mark.parametrize("hop_mode", ["auto", "pallas", "pallas-mxu", "xla"])
@pytest.mark.parametrize("w", [1, 8, 9, 16])
def test_resolvers_route_wide_windows(w, hop_mode, t, k):
    cfg = _cfg(w, hop_mode, t, k)
    fits = w <= 8 and (2 * t + 1) * k <= 32768
    assert hk._fused_shape_ok(w, t, k) == fits
    fused = hop_mode != "xla"
    assert hk.resolve_hop_mode(cfg) == ("pallas" if fused and fits
                                        else "xla")
    assert hk.resolve_emit_mode(cfg) == ("pallas" if fused and w <= 8
                                         else "xla")
    # the config gate still applies on top of the shapes
    gated = dataclasses.replace(cfg, gater_enabled=True)
    assert hk.resolve_hop_mode(gated) == "xla"
    assert hk.resolve_emit_mode(gated) == hk.resolve_emit_mode(cfg)


def test_resolvers_refuse_unknown_modes():
    for fn in (hk.resolve_hop_mode, hk.resolve_emit_mode):
        with pytest.raises(ValueError, match="unknown hop_mode"):
            fn(_cfg(2, "bogus", 1, 32))


@pytest.mark.parametrize("t,k", TK)
@pytest.mark.parametrize("w", [1, 8, 9, 16])
def test_wrappers_refuse_what_the_resolvers_route_away(monkeypatch, w, t, k):
    """On the kernel route the fused wrappers refuse, before any launch,
    what their kernels cannot hold: hop and emit refuse W > 8 only, and
    iwant_resolve refuses what ``_fused_shape_ok`` rejects (W > 8 or
    (2T+1) * K > 32768). The hop takes a (2T+1) * K beyond the resolve's
    tile, which the resolvers send away from it all the same."""
    launched = []
    monkeypatch.setattr(cudalib, "use_kernel", lambda name, *x: True)
    monkeypatch.setattr(cudalib, "check_args", lambda name, specs: None)
    monkeypatch.setattr(cudalib, "launch",
                        lambda name, *a: launched.append(name))
    n, m = 2, 32 * w
    words = torch.zeros((w, n), dtype=torch.int32)
    one = torch.zeros((w, 1), dtype=torch.int32)
    tb = torch.zeros((t, w), dtype=torch.int32)
    nbr = torch.zeros((n, k), dtype=torch.int32)
    planes = torch.zeros((n, t, k), dtype=torch.uint8)
    counts = torch.zeros((1, 1, 1), dtype=torch.uint8)   # not read here
    calls = {
        "hop": lambda: hk.hop(words, words.clone(), words.clone(),
                              words.clone(), words, words, words, one, nbr,
                              planes, planes, tb, counts, counts, counts),
        "iwant_resolve": lambda: hk.iwant_resolve(
            torch.full((n, m), -1, dtype=torch.int32), words, words, words,
            words, one, torch.zeros((n, k), dtype=torch.uint8), tb, nbr, m),
        "emit": lambda: hk.emit(words, words, planes, tb, nbr, m, m),
    }
    fused = hk.resolve_hop_mode(_cfg(w, "pallas", t, k)) == "pallas"
    takes = {"hop": w <= 8, "iwant_resolve": fused,
             "emit": hk.resolve_emit_mode(_cfg(w, "pallas", t, k)) == "pallas"}
    for name, call in calls.items():
        if takes[name]:
            call()
            assert launched[-1] == name
        else:
            before = len(launched)
            with pytest.raises(ValueError, match=name):
                call()
            assert len(launched) == before


def _arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _port(jcfg, jtp, jst):
    return (SimConfig(**dataclasses.asdict(jcfg)),
            TopicParams(*[torch.from_numpy(np.array(x)) for x in jtp]),
            state_from_reference(_arrays(jst), device="cpu"))


def _assert_equal(ref: dict, got: dict):
    for f, want in ref.items():
        have = got[f]
        assert have.dtype == want.dtype, (f, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=f)


def _run_asking(monkeypatch, st, cfg, tp, ticks):
    """The port's ``run`` on the CPU, with the kernels each wrapper asked
    ``cudalib.use_kernel`` for."""
    asked = set()
    real = cudalib.use_kernel

    def spy(name, *tensors):
        asked.add(name)
        return real(name, *tensors)

    monkeypatch.setattr(cudalib, "use_kernel", spy)
    out = run(st, cfg, tp, rng.PRNGKey(0, device="cpu"), ticks, device="cpu")
    return out, asked


def test_wide_window_trajectory_equals_reference(monkeypatch):
    """The headline network at 256 peers with a 288-message window (W = 9)
    and int32 counts, under the builder's ``hop_mode="pallas"``: the port
    routes the hop, resolve and emit to the non-fused path, asks for the
    bit-table and words gathers only, and after 4 ticks equals the JAX
    package in every field."""
    jcfg, jtp, jst = _build(256, 32, 12, msg_window=288)
    jcfg = dataclasses.replace(jcfg, hop_mode="xla", edge_gather_mode="pallas",
                               count_dtype="int32")
    jout = jrun(jst, jcfg, jtp, jax.random.PRNGKey(0), 4)
    cfg, tp, st = build_headline(256, msg_window=288, publishers=4,
                                 device="cpu")
    cfg = dataclasses.replace(cfg, count_dtype="int32")
    assert cfg.hop_mode == "pallas"
    assert dataclasses.replace(cfg, hop_mode="xla") == \
        SimConfig(**dataclasses.asdict(jcfg))
    assert hk.resolve_hop_mode(cfg) == hk.resolve_emit_mode(cfg) == "xla"
    _assert_equal(_arrays(jst), state_to_numpy(st))
    out, asked = _run_asking(monkeypatch, st, cfg, tp, 4)
    assert asked == {"edge_table", "gather_words"}
    ref = _arrays(jout)
    _assert_equal(ref, state_to_numpy(out))
    assert ref["delivered_total"] > 0 and ref["fault_flags"] == 0


def test_int32_counts_churn_equals_reference(monkeypatch):
    """churn_50k at 256 peers (gater, validation cap cut to 4, connection
    churn) with int32 hop counts on the non-fused path: 4 ticks equal the
    JAX package in every field, the gater's ignore and duplicate counts
    included."""
    jcfg, jtp, jst = jscenarios.churn_50k(n_peers=256)
    jcfg = dataclasses.replace(jcfg, hop_mode="xla", edge_gather_mode="pallas",
                               validation_queue_cap=4, count_dtype="int32")
    jout = jrun(jst, jcfg, jtp, jax.random.PRNGKey(0), 4)
    cfg, tp, st = _port(jcfg, jtp, jst)
    out, asked = _run_asking(monkeypatch, st, cfg, tp, 4)
    assert asked == {"edge_table", "gather_words", "permutation_gather"}
    ref = _arrays(jout)
    _assert_equal(ref, state_to_numpy(out))
    assert ref["delivered_total"] > 0 and ref["gater_throttle"].sum() > 0


@pytest.mark.parametrize("count_dtype,window", [("uint8", 288),
                                                ("int16", 64)])
def test_counts_refuse_what_the_reference_refuses(count_dtype, window):
    """A window the uint8 accumulators would wrap, and a count type the
    reference does not take, raise ValueError as the reference does."""
    cfg, tp, st = build_headline(64, k_slots=8, degree=4, msg_window=window,
                                 device="cpu")
    cfg = dataclasses.replace(cfg, count_dtype=count_dtype)
    with pytest.raises(ValueError, match="count_dtype|msg_window"):
        step(st, cfg, tp, rng.PRNGKey(0, device="cpu"), device="cpu")

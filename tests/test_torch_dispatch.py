"""Parity of the port's cost-model dispatch (go_libp2p_pubsub_tpu_torch/ops/
dispatch.py) with the JAX package's on the CPU.

- ``explain``, ``choose``, ``cost_ms``, ``explain_bucketed`` and
  ``choose_bucketed`` equal to the reference's for all six ops over a grid
  of shapes, under the ``cpu``, ``tpu`` and an unknown backend (which both
  take the ``default`` entry); float costs equal, not close.
- The same under a calibrated table (measured records and quarantines),
  passed as ``table=`` and loaded through ``GRAFT_DISPATCH_TABLE``.
- ``_validate``'s refusals, and the shipped table's reference entries
  copied verbatim.
- The port's ``cuda`` entry: ``"auto"`` resolves every path to the
  formulation the port ran before it had a dispatch table, for the
  headline, the BASELINE configs, the fault scenarios and the frontier.
- ``resolved_formulations`` for explicit modes equal to the reference's
  wherever the reference's TPU VMEM gates do not degrade them."""

import dataclasses
import json
import math

import pytest

from __graft_entry__ import _build
from go_libp2p_pubsub_tpu.ops import dispatch as jdp
from go_libp2p_pubsub_tpu.sim import scenarios as jscenarios
from go_libp2p_pubsub_tpu_torch.ops import dispatch as dp
from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
from go_libp2p_pubsub_tpu_torch.sim import SimConfig

BACKENDS = ("cpu", "tpu", "no-such-backend")
GRID = {
    "edge_permute": [dict(n=n, k=k, itemsize=i, have_sort_key=s)
                     for n in (1024, 10_000, 102_400, 1 << 20)
                     for k in (16, 32, 48) for i in (1, 4, 8)
                     for s in (True, False)],
    "words": [dict(w=w, n=n, k=k, itemsize=i, have_sort_key=s)
              for w in (1, 2, 9) for n in (1024, 102_400, 1 << 20)
              for k in (16, 32, 48) for i in (1, 4) for s in (True, False)],
    "edge_packed": [dict(n=n, k=k, b=b) for n in (1024, 51_200, 1 << 20)
                    for k in (16, 32, 48) for b in (1, 2, 8, 18, 40)],
    "hop": [dict(w=w, n=n, k=k) for w in (1, 2, 9)
            for n in (1024, 102_400, 1 << 20) for k in (16, 32, 48)],
    "emit": [dict(w=w, n=n, k=k) for w in (1, 2, 9)
             for n in (1024, 102_400, 1 << 20) for k in (16, 32, 48)],
    "selection": [dict(k=k, max_count=mc) for k in (16, 32, 48, 128)
                  for mc in (None, 1, 4, 12, 24, 25, 48, 200)],
}
BUCKETS = ((4096, 8), (1024, 32), (64, 128))


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv("GRAFT_DISPATCH_TABLE", raising=False)
    dp.clear_table_cache()
    jdp.clear_table_cache()
    yield
    dp.clear_table_cache()
    jdp.clear_table_cache()


def _same_costs(want: dict, got: dict, what):
    assert list(want) == list(got), what
    for form, ms in want.items():
        assert got[form] == ms or (math.isinf(ms) and math.isinf(got[form])), \
            (what, form, ms, got[form])


def _rank_everything(table=None, jtable=None, backends=BACKENDS):
    for backend in backends:
        for op, shapes in GRID.items():
            for shape in shapes:
                what = (backend, op, shape)
                _same_costs(jdp.explain(op, backend, jtable, **shape),
                            dp.explain(op, backend, table, **shape), what)
                assert dp.choose(op, backend, table, **shape) \
                    == jdp.choose(op, backend, jtable, **shape), what
            bshape = {k: v for k, v in shapes[0].items()
                      if k not in ("n", "k")}
            _same_costs(jdp.explain_bucketed(op, BUCKETS, backend, jtable,
                                             **bshape),
                        dp.explain_bucketed(op, BUCKETS, backend, table,
                                            **bshape), (backend, op))
            assert dp.choose_bucketed(op, BUCKETS, backend, table, **bshape) \
                == jdp.choose_bucketed(op, BUCKETS, backend, jtable, **bshape)


class TestShippedTable:
    def test_reference_entries_verbatim(self):
        ref = jdp.load_table()["platforms"]
        port = dp.load_table()["platforms"]
        for plat in ("cpu", "tpu", "default"):
            assert port[plat] == ref[plat], plat
        assert dp.OPS == jdp.OPS and dp._COEFF_KEYS == jdp._COEFF_KEYS

    def test_cost_ms_equal(self):
        for plat, entry in dp.load_table()["platforms"].items():
            for op, shapes in GRID.items():
                for form in dp.OPS[op]:
                    for shape in shapes:
                        want = jdp.cost_ms(op, form, entry["coefficients"],
                                           **shape)
                        got = dp.cost_ms(op, form, entry["coefficients"],
                                         **shape)
                        assert got == want or (math.isinf(want)
                                               and math.isinf(got)), \
                            (plat, op, form, shape)

    def test_rankings_equal(self):
        _rank_everything()

    def test_cuda_entry_quarantines(self):
        entry = dp.load_table()["platforms"]["cuda"]
        assert entry["coefficients"]["pallas_overhead"] == 1.0
        assert entry["coefficients"]["mem_gbps"] == 3350
        for op in ("edge_permute", "words", "edge_packed"):
            assert dp.choose(op, "cuda", **GRID[op][0]) == ["pallas"]
        for op in ("hop", "emit"):
            assert "xla" not in dp.choose(op, "cuda", **GRID[op][0])
        assert dp.choose("selection", "cuda", k=32, max_count=12) \
            == ["ranks"]
        assert dp.BACKEND == "cuda"


class TestCalibratedTable:
    """A table whose tpu entry holds measured records and other
    quarantines ranks the same in both packages, whether it is passed as
    ``table=`` or loaded through GRAFT_DISPATCH_TABLE."""

    def _table(self):
        table = json.loads(json.dumps(jdp.load_table()))
        entry = table["platforms"]["tpu"]
        entry["measured"] = [
            {"op": "words", "shape": {"w": 2, "n": 102_400, "k": 32},
             "ms": {"sort": 9.0, "mxu": 0.8, "rows": 24.7}},
            {"op": "edge_permute", "shape": {"n": 1024, "k": 32},
             "ms": {"scalar": 0.5, "sort": 0.5}},
            {"op": "hop", "shape": {"w": 2, "n": 1 << 20, "k": 32},
             "ms": {"pallas": 1.0, "xla": 1.0}},
        ]
        entry["quarantined"] = {"words": ["scalar", "pallas"],
                                "edge_packed": ["sort"],
                                "selection": ["ranks"]}
        return table

    def test_by_argument(self):
        table = self._table()
        _rank_everything(table, table)
        assert jdp.choose("words", "tpu", table, w=2, n=102_400, k=32,
                          have_sort_key=True)[0] == "mxu"

    def test_by_environment(self, tmp_path, monkeypatch):
        path = tmp_path / "calibrated.json"
        path.write_text(json.dumps(self._table()))
        monkeypatch.setenv("GRAFT_DISPATCH_TABLE", str(path))
        _rank_everything()
        assert "sort" not in dp.choose("edge_packed", "tpu", n=1024, k=32,
                                       b=2)


def test_validate_refusals(tmp_path):
    cases = [{"platforms": {"cpu": {}}},                    # no version
             {"version": 1},                                # no platforms
             {"version": 1, "platforms": {"x": {"coefficients": {}}}},
             {"version": 1, "platforms": {"x": {
                 "coefficients": dict.fromkeys(dp._COEFF_KEYS, 1.0),
                 "quarantined": {"bogus": ["pallas"]}}}}]
    for i, bad in enumerate(cases):
        path = tmp_path / f"bad{i}.json"
        path.write_text(json.dumps(bad))
        for mod in (dp, jdp):
            with pytest.raises(mod.DispatchTableError):
                mod.load_table(str(path))
    good = {"version": 1, "platforms": {"x": {
        "coefficients": dict.fromkeys(dp._COEFF_KEYS, 1.0)}}}
    assert dp._validate(good, "good") is good


def _before_dispatch(cfg) -> dict:
    """The port's choices before it had a dispatch table: the three
    kernels under "auto"/"pallas", the fused hop wherever the config and
    shapes allow it, the fused emit at W <= 8, the rank selection."""
    w = (cfg.msg_window + 31) // 32
    gather = "pallas" if cfg.edge_gather_mode == "auto" \
        else cfg.edge_gather_mode
    fused = cfg.hop_mode != "xla"
    hop = fused and hk._hop_config_ok(cfg) and hk._fused_shape_ok(
        w, cfg.n_topics, cfg.k_slots)
    return {"edge_permute": gather, "words": gather, "edge_packed": gather,
            "hop": "pallas" if hop else "xla",
            "emit": "pallas" if fused and w <= 8 else "xla",
            "selection": "ranks"}


def _configs():
    """Each config the port runs, at its full size (n_peers replaced on a
    small build: the config's other fields do not depend on it)."""
    yield "headline", dataclasses.replace(_build(64, 8, 4)[0],
                                          n_peers=102_400, k_slots=32)
    for name, n in (("single_topic_1k", 1024), ("beacon_10k", 10_240),
                    ("churn_50k", 51_200), ("sybil_100k", 102_400),
                    ("partition_50k", 51_200), ("outage_10k", 10_240)):
        cfg = getattr(jscenarios, name)(n_peers=64, degree=4)[0]
        yield name, dataclasses.replace(cfg, n_peers=n)
    for router in ("floodsub", "randomsub", "gossipsub"):
        cfg = jscenarios.router_sweep_100k(router, n_peers=64, degree=4)[0]
        yield router, dataclasses.replace(cfg, n_peers=102_400)
    yield "frontier_1m", jscenarios.frontier_cfg(1 << 20)


def test_cuda_entry_keeps_the_choices_before_dispatch():
    seen = set()
    for name, jcfg in _configs():
        cfg = SimConfig(**dataclasses.asdict(jcfg))
        got = dp.resolved_formulations(cfg)
        assert got == _before_dispatch(cfg), (name, got)
        seen.add((got["hop"], got["edge_packed"]))
    # the fused path, the non-fused hop (churn's gater) and the sort path
    assert {("pallas", "pallas"), ("xla", "pallas"),
            ("pallas", "sort")} <= seen


@pytest.mark.parametrize("n", [1024, 10_240, 102_400])
def test_resolved_formulations_explicit_modes_equal(n):
    """Explicit modes: the port's resolution equals the reference's where
    the reference's VMEM gates keep the mode; where they degrade it
    (``pallas`` payloads above ~8 MB), the port keeps the kernel, whose
    output is the same. ``pallas-mxu`` runs the fused kernels, which
    ``resolved_formulations`` reads as ``"pallas"``."""
    base = _build(64, 32, 4)[0]
    for gather in ("scalar", "rows", "sort", "pallas", "mxu"):
        for hop in ("xla", "pallas", "pallas-mxu"):
            for selection in ("iter", "sort", "ranks"):
                jcfg = dataclasses.replace(
                    base, n_peers=n, edge_gather_mode=gather, hop_mode=hop,
                    selection_mode=selection)
                want = jdp.resolved_formulations(jcfg)
                got = dp.resolved_formulations(
                    SimConfig(**dataclasses.asdict(jcfg)))
                assert got["selection"] == want["selection"] == selection
                assert got["hop"] == ("xla" if hop == "xla" else "pallas")
                assert want["hop"] == hop
                assert got["emit"] == got["hop"]
                for seam in ("edge_permute", "words", "edge_packed"):
                    assert got[seam] == gather, (seam, got)
                    if want[seam] != gather:
                        assert (gather, want[seam], n) == ("pallas", "rows",
                                                           102_400), \
                            (seam, want[seam])

"""The port's dispatch calibrator (go_libp2p_pubsub_tpu_torch/
calibrate_dispatch.py) on the CPU, against scripts/calibrate_dispatch.py's
rules.

A one-shape run (n = 256, k = 16, m = 64, 1 repeat) measures the (op,
formulation) pairs the reference's calibrator measures at that shape,
writes a table that ``ops.dispatch.load_table`` validates, with the
records in the ``cpu`` entry and the shipped entries kept, that
``explain`` reads (and ``"auto"`` ranks by, under GRAFT_DISPATCH_TABLE),
and a rerun resumes from its journal without measuring again. The merge
quarantines as the reference's merge does on the same journal; a
formulation that fails is quarantined; a kernel label whose kernel did
not launch fails the run.
"""

import json

import pytest
import torch

from go_libp2p_pubsub_tpu_torch import calibrate_dispatch as cd
from go_libp2p_pubsub_tpu_torch.ops import dispatch
from scripts import calibrate_dispatch as jcd

SHAPE = (256, 16, 64)
W = (SHAPE[2] + 31) // 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread while this module runs (the
    suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cal") / "table.json")
    lines = []
    table = cd.calibrate([SHAPE], out, repeats=1, device="cpu",
                         emit=lines.append)
    return out, table, [json.loads(ln) for ln in lines]


def test_measures_the_reference_calibrators_pairs(calibrated):
    _, _, lines = calibrated
    got = {(r["op"], r["form"], tuple(sorted(r["shape"].items())))
           for r in lines if "op" in r}
    want = {(op, form, tuple(sorted(shape.items())))
            for op, form, shape, _fn, _args in jcd._measurements(*SHAPE)}
    assert got == want
    assert all("ms" in r and r["ms"] > 0 for r in lines if "op" in r)


def test_table_validates_and_explain_reads_it(calibrated, monkeypatch):
    out, table, lines = calibrated
    loaded = dispatch.load_table(out)
    assert loaded == table
    shipped = dispatch.load_table(dispatch.DEFAULT_TABLE_PATH)
    for plat in ("cuda", "tpu", "default"):
        assert loaded["platforms"][plat] == shipped["platforms"][plat]
    entry = loaded["platforms"]["cpu"]
    assert entry["fingerprint"] == dispatch.platform_fingerprint("cpu")
    assert entry["fingerprint"]["platform"] == "cpu"
    measured = {(r["op"], r["form"]): r["ms"] for r in lines if "op" in r}
    shapes = {"words": {"w": W, "n": 256, "k": 16},
              "edge_permute": {"n": 256, "k": 16},
              "edge_packed": {"n": 256, "k": 16, "b": 4},
              "selection": {"k": 16, "max_count": 12},
              "hop": {"w": W, "n": 256, "k": 16},
              "emit": {"w": W, "n": 256, "k": 16}}
    for op, shape in shapes.items():
        costs = dispatch.explain(op, backend="cpu", table=loaded, **shape)
        quarantined = set(entry["quarantined"].get(op, ()))
        assert set(costs) == {f for o, f in measured if o == op} - quarantined
        for form, ms in costs.items():
            assert ms == measured[(op, form)], (op, form)
    # the hop and the emit share one timing a formulation
    assert measured[("hop", "xla")] == measured[("emit", "xla")]
    monkeypatch.setenv("GRAFT_DISPATCH_TABLE", out)
    dispatch.clear_table_cache()
    try:
        costs = dispatch.explain("words", backend="cpu", **shapes["words"])
        assert dispatch.choose("words", backend="cpu", **shapes["words"])[0] \
            == min(costs, key=costs.get)
    finally:
        dispatch.clear_table_cache()


def test_rerun_resumes_from_the_journal(calibrated):
    out, table, lines = calibrated
    n_points = sum(1 for r in lines if "op" in r)
    again = []
    table2 = cd.calibrate([SHAPE], out, repeats=1, device="cpu",
                          emit=again.append)
    info = [json.loads(ln) for ln in again]
    assert info[0]["resumed_points"] == n_points
    assert [r.get("info") for r in info] == ["calibrate_dispatch",
                                             "dispatch table written"]
    assert table2["platforms"]["cpu"] == table["platforms"]["cpu"]


def test_merge_quarantines_as_the_reference(tmp_path):
    fp = {"platform": "cpu", "device_kind": "", "torch": "x"}
    journal = {}
    times = {("words", "scalar"): 1.0, ("words", "rows"): 3.5,
             ("words", "pallas"): 2.0, ("selection", "iter"): 0.5,
             ("selection", "ranks"): 1.4}
    for shape in ({"n": 256, "k": 16, "w": 2}, {"n": 4096, "k": 16, "w": 2}):
        for (op, form), ms in times.items():
            sh = shape if op == "words" else {"k": 16, "max_count": 12}
            key = (op, form, tuple(sorted(sh.items())))
            journal[key] = {"op": op, "form": form, "shape": sh, "ms": ms}
    journal[("words", "sort", (("k", 16), ("n", 256), ("w", 2)))] = {
        "op": "words", "form": "sort", "shape": {"n": 256, "k": 16, "w": 2},
        "error": "cannot run"}
    mine = cd.merge_table(str(tmp_path / "a.json"), "cpu", fp, journal, 3.0)
    ref = jcd._merge_table(str(tmp_path / "b.json"), "cpu", fp, journal, 3.0)
    for key in ("measured", "quarantined", "fingerprint"):
        assert mine["platforms"]["cpu"][key] == ref["platforms"]["cpu"][key]
    assert mine["platforms"]["cpu"]["quarantined"] == {"words": ["rows",
                                                                 "sort"]}
    dispatch.load_table(str(tmp_path / "a.json"))


def test_a_failing_formulation_is_quarantined(tmp_path, monkeypatch):
    def measurements(n, k, m, dev, t=2, topo=None):
        def boom():
            raise RuntimeError("no such formulation here")
        yield ("words",), "sort", {"w": 2, "n": n, "k": k}, boom, ()
        yield ("words",), "scalar", {"w": 2, "n": n, "k": k}, lambda: 0, ()
    monkeypatch.setattr(cd, "measurements", measurements)
    out = str(tmp_path / "t.json")
    lines = []
    table = cd.calibrate([SHAPE], out, repeats=1, device="cpu",
                         emit=lines.append)
    assert table["platforms"]["cpu"]["quarantined"] == {"words": ["sort"]}
    recs = [json.loads(ln) for ln in lines if '"op"' in ln]
    assert "error" in recs[0] and "ms" in recs[1]


def test_a_kernel_label_must_launch_its_kernel():
    before = {"gather_words": 3, "take_words": 0, "hop": 5, "emit": 5}
    cd._check_launches(("words",), "pallas", before,
                       {**before, "gather_words": 4})
    with pytest.raises(RuntimeError, match="without launching"):
        cd._check_launches(("words",), "pallas", before, before)
    with pytest.raises(RuntimeError, match="without launching"):
        cd._check_launches(("hop", "emit"), "pallas", before,
                           {**before, "hop": 9})
    with pytest.raises(RuntimeError, match="plain words/rows launched"):
        cd._check_launches(("words",), "rows", before,
                           {**before, "take_words": 1})
    cd._check_launches(("hop", "emit"), "xla", before, before)

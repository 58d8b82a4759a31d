"""The per-layer metrics that read the program's inner spans (seam solve,
seam fetch / problem / band, dp scan, grouping's detect and
register+fetch, tile fetch and rows out): each sums its records over a
sortie and takes the mean over the window's sortie; the stage metrics
read the same records as before the inner spans."""

import pytest

from mosaicbench import harness as H


def _records(k):
    """One sortie's records in the shape the program writes, the inner
    spans' seconds scaled by ``k`` so two sorties differ."""
    recs = [{"stage": "Main", "msg": "grouping done", "seconds": 2.0,
             "parent": None},
            {"stage": "VisualGroup", "msg": "detect done", "seconds": 0.5 * k,
             "parent": "grouping done", "frames": 60},
            {"stage": "VisualGroup", "msg": "register+fetch done",
             "seconds": 0.25 * k, "parent": "grouping done"},
            {"stage": "VisualGroup", "msg": "segment done", "seconds": 0.1,
             "parent": "grouping done"},
            {"stage": "Main", "msg": "groups", "sizes": [20, 20]}]
    for gi in range(2):
        recs += [{"stage": f"Strip{gi}", "msg": "dp scan done",
                  "seconds": 0.125 * k, "rows": 320, "cols": 64,
                  "parent": "seams done"},
                 {"stage": f"Strip{gi}", "msg": "seams done", "seconds": 1.0,
                  "parent": "stitch done"},
                 {"stage": f"Strip{gi}", "msg": "tile feed done",
                  "seconds": 0.01, "frames": 3, "parent": "tiled blend done"},
                 {"stage": f"Strip{gi}", "msg": "tiled blend done",
                  "seconds": 0.3, "parent": "stitch done"}]
    recs += [{"stage": "Single", "msg": "tile fetch done",
              "seconds": 0.0625 * k, "bytes": 100,
              "parent": "tiled blend done"}]
    for solve, nodes in ((0.75, 100_000), (1.5, 2_000_000)):
        recs += [{"stage": "GlobalCustom", "msg": "seam fetch done",
                  "seconds": 0.0625 * k, "parent": "seams done"},
                 {"stage": "GlobalCustom", "msg": "seam problem done",
                  "seconds": 0.125 * k, "parent": "seams done"},
                 {"stage": "GlobalCustom", "msg": "seam band done",
                  "seconds": 0.25 * k, "parent": "seams done"},
                 {"stage": "GlobalCustom", "msg": "seam solve done",
                  "seconds": solve * k, "nodes": nodes * k,
                  "parent": "seams done"}]
    recs += [{"stage": "GlobalCustom", "msg": "seams done", "seconds": 9.0,
              "parent": "global compose done"},
             {"stage": "GlobalCustom", "msg": "seam solver", "calls": 2,
              "solver_seconds": 2.25, "nodes": 2_100_000},
             {"stage": "GlobalCustom", "msg": "rows out done",
              "seconds": 0.125 * k, "parent": "blend done"},
             {"stage": "GlobalCustom", "msg": "tile fetch done",
              "seconds": 0.25 * k, "bytes": 1000, "parent": "blend done"}]
    return recs


def _ctx(*ks):
    return H.Context(units=[{"seconds": 20.0, "records": _records(k)}
                            for k in ks])


@pytest.mark.parametrize("name,per_k", [
    ("seam_solve_s", 2.25),
    ("seam_prep_s", 2 * (0.0625 + 0.125 + 0.25)),
    ("seam_solve_mnodes", 2.1),
    ("dp_scan_s", 2 * 0.125),
    ("group_detect_s", 0.5),
    ("group_register_s", 0.25),
    ("blend_fetch_s", 0.0625 + 0.125 + 0.25),
])
def test_inner_span_metrics_sum_a_sortie_and_average_the_window(name,
                                                                 per_k):
    read = H.reader(name)
    assert read(_ctx(1)) == pytest.approx(per_k)
    # the mean over the window: sorties of k = 1 and 3
    assert read(_ctx(1, 3)) == pytest.approx(2 * per_k)


@pytest.mark.parametrize("name,value", [
    ("global_seams_s", 9.0), ("strip_seams_s", 2.0), ("grouping_s", 2.0),
    ("strip_blend_s", 0.6)])
def test_stage_metrics_read_the_same_records(name, value):
    assert H.reader(name)(_ctx(1, 3)) == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "seam_solve_s", "seam_prep_s", "seam_solve_mnodes", "dp_scan_s",
    "blend_fetch_s"])
def test_a_program_without_the_spans_reads_nothing(name):
    """The parent's records (stage spans only): the metric is left out."""
    recs = [r for r in _records(1)
            if r["msg"] in ("grouping done", "seams done", "detect done",
                            "tiled blend done", "seam solver")]
    assert H.reader(name)(H.Context(units=[{"records": recs}])) is None

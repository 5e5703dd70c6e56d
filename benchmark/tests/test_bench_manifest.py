"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import json
import os
import re

import pytest

from benchmark import common, compare

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    with open(os.path.join(common.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    n = len(MAN["workloads"])
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert c["file"].startswith("benchmark/") and \
            os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        names.append(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    c = common.cell(w["name"])
    kind = c["traffic_data"]["kind"]
    assert os.path.exists(os.path.join(common.HERE, "drivers", kind + ".py"))
    assert compare.limits(w["name"])
    e2e = common.metrics_of(w["name"], MAN, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per = common.metrics_of(w["name"], MAN, trace=True)
    assert per
    for m in e2e + per:
        assert hasattr(common.load_file("metrics", m["name"]), "read")
    for m in per:    # a per-layer metric's moved metric is reported here
        assert m["moves"] in names


def test_configs_state_their_cut():
    for c in MAN["configs"]:
        cfg = common.load_json(common.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
        pub = cfg["published"]
        # the app stores 2 * dim reals an embedding: the published width
        assert 2 * cfg["dim"] == pub["dim"] == 512
        assert cfg["entities"] == pub["entities"] == 4_594_485
        assert cfg["relations"] == pub["relations"] == 822
        assert "assumed" in cfg


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_limits_files_are_json():
    for w in MAN["workloads"]:
        with open(os.path.join(common.HERE, "limits",
                               w["name"] + ".json")) as f:
            assert all(v >= 0 for v in json.load(f)["limits"].values())


def test_files_found_by_name_fall_back_to_the_base_name():
    """A metric split by kind of cell (device_idle.eval, .train) is read by
    one reader of its base name; a model is the reference module of its
    name."""
    from benchmark.reference import model
    base = os.path.join(common.HERE, "metrics", "device_idle.py")
    for name in ("device_idle.eval", "device_idle.train", "device_idle"):
        assert common.load_file("metrics", name).__file__ == base
    assert model("complex").entity_emb(3) == 6

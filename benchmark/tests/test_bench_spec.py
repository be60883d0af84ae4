"""The harness finds configurations, cells, traffic and metrics by name,
and takes a new one from files alone."""

import json
import os
import shutil
import types

import pytest

from benchmark.spec import HERE, Spec


def test_finds_every_name_of_benchmark_json():
    spec = Spec(os.path.dirname(HERE))
    for cell in spec.data["workloads"]:
        cfg = spec.config(cell)
        assert cfg["name"] == cell["config"]
        assert spec.traffic(cell)["ranks"] == cell["chips"]
        for trace in (False, True):
            for m in spec.metrics(cell, trace):
                assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in spec.metrics(spec.cell(
        "default_18_8.prove"), False)}
    assert names == {"rows_per_s", "round_p95_ms", "setup_s"}
    names = {m["name"] for m in spec.metrics(spec.cell(
        "mainnet_24_8.prove"), True)}
    assert "launches_per_round" not in names and "msm_roofline_pct" in names


def test_a_new_cell_config_traffic_and_metric_from_files_alone(tmp_path):
    root = tmp_path
    shutil.copy(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"),
                root / "BENCHMARK.json")
    data = json.loads((root / "BENCHMARK.json").read_text())
    (root / "new.json").write_text(json.dumps(
        {"name": "testnet_20_8", "scale": 20, "machines_scale": 8}))
    (root / "traffic").mkdir()
    (root / "traffic" / "closed_pool2.json").write_text(json.dumps(
        {"pool": 2, "ranks": 1, "sampled_rounds": 1,
         "srs_samples": {"g1_x": 1, "bases": 1, "lagrange_y": 1}}))
    data["configs"].append({"name": "testnet_20_8", "source": "x",
                            "file": "new.json", "reduced": [], "why": "x"})
    data["workloads"].append({"name": "testnet_20_8.prove",
                              "config": "testnet_20_8",
                              "traffic": "closed_pool2", "chips": 1,
                              "why": "x"})
    data["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "rows_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    shutil.copytree(os.path.join(HERE, "metrics"), root / "metrics")
    (root / "metrics" / "rounds_seen.py").write_text(
        "def read(ctx):\n    return ctx.rounds\n")
    spec = Spec(str(root), bench_dir=str(root))
    cell = spec.cell("testnet_20_8.prove")
    assert spec.config(cell)["scale"] == 20
    assert spec.traffic(cell)["pool"] == 2
    names = [m["name"] for m in spec.metrics(cell, True)]
    assert "rounds_seen" in names and "collective_ms" not in names
    assert spec.reader("rounds_seen")(types.SimpleNamespace(rounds=7)) == 7


def test_benchmark_json_has_its_keys_and_a_reader_a_metric():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        data = json.load(f)
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"]
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    assert sum(c["chips"] == 4 for c in data["workloads"]) <= max(
        1, len(data["workloads"]) // 4)


def test_a_new_layer_from_a_file_alone(tmp_path):
    shutil.copy(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(HERE, "layers"), tmp_path / "layers")
    (tmp_path / "layers" / "aggregation.json").write_text(json.dumps(
        {"about": "x", "order": 35,
         "rules": [{"span": "prove", "kernels": ["g1_msm_fixed"]}]}))
    rules = Spec(str(tmp_path), bench_dir=str(tmp_path)).layer_rules()
    assert [r["layer"] for r in rules] == ["collective", "ntt", "fr_open",
                                           "aggregation", "msm"]
    from benchmark import trace
    assert trace.layer_of("prove", "g1_msm_fixed_kernel", rules) == \
        "aggregation"
    assert trace.layer_of("prove", "msm_buckets_kernel", rules) == "msm"
    assert trace.layer_of("prove", "fr_mul_kernel", rules) == "fr_open"


def test_traffic_reads_its_batch_and_transforms():
    from benchmark.traffic import Traffic
    cfg = {"scale": 6, "machines_scale": 2}
    plain = Traffic({"pool": 1}, cfg, 1)
    assert (plain.batch, plain.batch_ranks, plain.transforms) == (1, 1,
                                                                  ["x"])
    tr = Traffic({"pool": 1, "ranks": 4, "challenges_per_round": 4,
                  "batch_ranks": 2, "transforms": ["y", "x"]}, cfg, 1)
    assert (tr.machine_ranks, tr.rank_batch, tr.rows_per_round) == (2, 2,
                                                                    16)
    for bad in ({"transforms": ["z"]}, {"transforms": ["x", "x"]},
                {"ranks": 3, "batch_ranks": 2}):
        with pytest.raises(ValueError):
            Traffic(dict({"pool": 1}, **bad), cfg, 1)

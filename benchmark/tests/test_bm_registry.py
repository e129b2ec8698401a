"""The harness finds every configuration, traffic mix, cell and metric by
its name, and finds new ones added as files beside them."""

import hashlib
import json
import os
import re
import shutil

import pytest

from benchmark import devtrace
from benchmark.registry import Registry
from benchmark.run import result_line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def reg():
    return Registry()


def test_every_name_resolves_to_its_files(reg):
    configs = [c["name"] for c in reg.spec["configs"]]
    for c in reg.spec["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert cfg["source"] == c["source"]
    for w in reg.spec["workloads"]:
        assert w["config"] in configs
        assert reg.traffic(w["traffic"])["kind"] == "train"
        assert reg.driver("train").run
        limits = reg.limits(w["name"])["limits"]
        assert limits and all(v > 0 for v in limits.values())
        for m in reg.per_layer(w["name"]):
            assert callable(reg.metric_reader(m["name"]).read)
    with pytest.raises(KeyError, match="no-such-cell"):
        reg.per_layer("no-such-cell")


def test_the_spec_keeps_to_its_shape(reg):
    spec = reg.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    named = spec["configs"] + spec["workloads"] + spec["end_to_end"] + \
        spec["per_layer"]
    assert all(NAME.match(x["name"]) for x in named)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] == "device_trace"
        assert len(m["layer"]) <= 200
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert len(json.dumps(spec)) < 64 * 1024


def _digests(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_config_cell_and_metric_added_as_files_are_found(reg, tmp_path):
    root = tmp_path / "checkout"
    folder = root / "benchmark"
    shutil.copytree(reg.folder, folder,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(reg.root, "BENCHMARK.json"), root)
    before = _digests(folder)

    base = reg.spec["configs"][0]
    cfg = dict(reg.config(base["name"]), name="new-model")
    (folder / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "train.b1.s4096.json").write_text(json.dumps(
        {"kind": "train", "batch": 1, "seq": 4096, "lr": 1.0,
         "checked_steps": 2, "loss_every": 10, "warm_steps": 1}))
    (folder / "workloads" / "new-model.train.s4096.json").write_text(
        json.dumps({"limits": {"update_gap": 0.25}}))
    (folder / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx['steps']) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(base, name="new-model",
                                file="benchmark/configs/new-model.json"))
    spec["workloads"].append({"name": "new-model.train.s4096",
                              "config": "new-model",
                              "traffic": "train.b1.s4096", "chips": 1,
                              "why": "a cell added as files"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "trainer step (tpu/train.py)",
                              "moves": "train_tokens_per_s",
                              "workloads": ["new-model.train.s4096"]})
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s",
                               "better": "higher", "bound": 0.02,
                               "source": "host_clock",
                               "workloads": ["new-model.train.s4096"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    new = Registry(root=str(root), folder=str(folder))
    assert new.workload("new-model.train.s4096")["config"] == "new-model"
    assert new.config("new-model")["model_config"] == cfg["model_config"]
    assert new.traffic("train.b1.s4096")["seq"] == 4096
    assert new.limits("new-model.train.s4096")["limits"] == {
        "update_gap": 0.25}
    old = reg.spec["workloads"][0]["name"]
    listed = [m["name"] for m in reg.spec["per_layer"]]
    # a metric without a list is read in every cell that reports what it
    # moves; one with a list, and a listed end-to-end metric, in those
    assert [m["name"] for m in new.per_layer(old)] == listed
    assert [m["name"] for m in new.per_layer("new-model.train.s4096")] == \
        listed + ["steps_in_window"]
    assert "steps_per_s" not in {m["name"] for m in new.end_to_end(old)}
    assert new.end_to_end("new-model.train.s4096")[-1]["name"] == \
        "steps_per_s"
    run = {"trace": {"busy_s": 1.0, "window_s": 1.0, "kernel_s": {},
                     "device_ops": [], "idle_gaps": []},
           "steps": 30, "model": cfg["model_config"], "correct": True,
           "attempted": 30, "failed": 0, "check": {}}
    line = result_line(new, "new-model.train.s4096", run, True, {},
                       new.traffic("train.b1.s4096"))
    assert line["metrics"]["steps_in_window"] == {"value": 30.0,
                                                  "unit": "steps"}
    # nothing that was there changed
    after = _digests(folder)
    assert {k: after[k] for k in before} == before


def _events():
    # (name, on the device, a user annotation, start us, end us)
    return [
        (devtrace.WINDOW, False, True, 100.0, 200.0),
        (devtrace.WINDOW, True, True, 100.0, 200.0),
        ("aten::mm", False, False, 100.0, 150.0),
        ("cudaStreamSynchronize", False, False, 160.0, 190.0),
        ("nvjet_tst_256x128", True, False, 90.0, 140.0),
        ("dq_wgmma_kernel<128>", True, False, 130.0, 150.0),
        ("xent_kernel<float>", True, False, 180.0, 190.0),
        ("outside", True, False, 300.0, 400.0),
    ]


def test_trace_reduction_on_the_window():
    tr = devtrace.reduce(_events())
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(60e-6)   # 100-150, 180-190
    assert tr["kernel_s"] == pytest.approx({"nvjet_tst_256x128": 40e-6,
                                            "dq_wgmma_kernel<128>": 20e-6,
                                            "xent_kernel<float>": 10e-6})
    assert [n for n, _ in tr["device_ops"]] == [
        "nvjet_tst_256x128", "dq_wgmma_kernel<128>", "xent_kernel<float>"]
    gaps = tr["idle_gaps"]
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(30e-6)
    assert sorted(g[1] for g in gaps) == pytest.approx([10e-6, 30e-6])


def test_trace_without_device_work_is_refused():
    events = [e for e in _events() if not e[1] or e[0] == devtrace.WINDOW]
    with pytest.raises(RuntimeError, match="no device operation"):
        devtrace.reduce(events)


def test_per_layer_readers_on_a_trace(reg):
    cell = reg.spec["workloads"][0]
    traffic = reg.traffic(cell["traffic"])
    m = reg.config(cell["config"])["model_config"]
    ctx = {"trace": devtrace.reduce(_events()), "steps": 1, "model": m,
           "traffic": traffic}
    got = {x["name"]: reg.metric_reader(x["name"]).read(ctx)
           for x in reg.per_layer(cell["name"])}
    assert got["device_idle_share"] == pytest.approx(40.0)
    assert got["flash_fwd_roofline"] is None   # no forward kernel ran
    assert got["rmsnorm_roofline"] is None
    assert got["eager_ms_per_step"] == 0.0
    assert got["flash_bwd_roofline"] > 0 and got["xent_roofline"] > 0

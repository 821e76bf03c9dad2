"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import json
import os
import re
import shutil

from pb_helpers import ROOT, bench, keep_renderers, toy  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PB = os.path.join(ROOT, "portbench")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(bench):
    names = []
    for entry in bench["configs"] + bench["workloads"] + \
            bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        names.append(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]

    def reports(m, cell):
        return cell in m.get("workloads", cells)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items()
                   if n != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_files_found_by_name(bench):
    from portbench.run import cell_setup
    for c in bench["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("portbench/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        _, config, traffic = cell_setup(bench, w["name"])
        assert os.path.isfile(os.path.join(PB, "drivers",
                                           traffic["kind"] + ".py"))
        assert os.path.isfile(os.path.join(PB, "limits",
                                           w["name"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(PB, "metrics", m["name"] + ".py"))


def test_cell_added_as_files_only(bench, tmp_path):
    """A new cell: a BENCHMARK.json entry, a traffic file and a limits file,
    no code; the harness takes it and runs it."""
    from portbench.run import run_cell
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(PB, sub), tmp_path / "portbench" / sub)
    with open(os.path.join(PB, "traffic", "cli_32.json")) as f:
        traffic = json.load(f)
    traffic["frames_per_call"] = 4
    (tmp_path / "portbench" / "traffic" / "cli_4.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench" / "limits" / "organic_sss_1080p_short.json") \
        .write_text(json.dumps({"gap_p50": 1e-3}))
    bench["workloads"].append({"name": "organic_sss_1080p_short",
                               "config": "organic_sss", "traffic": "cli_4",
                               "chips": 1, "why": "a test cell"})
    ov = toy(bench, "organic_sss_1080p")
    ov["traffic"] = {"frames_per_call": 1, "check_pixels": 16}
    res = run_cell(bench, "organic_sss_1080p_short", 5, 0.1, 0, "cpu", ov,
                   root=str(tmp_path))
    assert res["correct"] and set(res["check"]) == {"gap_p50"}
    assert res["attempted"] >= 1


def test_bounce_cell_added_as_files_only(bench, tmp_path, monkeypatch):
    """A bounce-integrator cell: a configuration file (testobj_large's
    scene with `settings: {"integrator": "bounce"}`), a limits file and
    entries in a copy of BENCHMARK.json, no edit of any file of
    portbench/; traced, the harness reads the bounce integrator's steps
    and counters (a counter it publishes reaches a reader file beside the
    cell), builds no regen integrator, and its comparison holds on the
    CPU."""
    from portbench.run import run_cell
    from tpu_pathtracer_torch.tracer import wavefront
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(PB, sub), tmp_path / "portbench" / sub)
    with open(os.path.join(PB, "configs", "testobj_large.json")) as f:
        config = json.load(f)
    config["name"] = "testobj_large_bounce"
    config["settings"] = {"integrator": "bounce"}
    pb = tmp_path / "portbench"
    (pb / "configs" / "testobj_large_bounce.json").write_text(
        json.dumps(config))
    (pb / "limits" / "testobj_large_bounce_1080p.json").write_text(
        json.dumps({"gap_p50": 1e-3, "far_share": 0.1}))
    (pb / "metrics" / "probe_steps.py").write_text(
        "def read(run):\n"
        "    return run.get(\"counters\", {}).get(\"probe_steps\")\n")
    cell = "testobj_large_bounce_1080p"
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({
        "name": "testobj_large_bounce", "source": "a test",
        "file": "portbench/configs/testobj_large_bounce.json",
        "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": cell,
                               "config": "testobj_large_bounce",
                               "traffic": "cli_32", "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        if m["name"] == "waves_per_frame":
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "probe_steps", "unit": "steps", "better": "lower",
        "source": "program_counter", "layer": "bounce loop",
        "moves": "frame_ms", "workloads": [cell]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append(cell)
    monkeypatch.setattr(wavefront.BounceIntegrator, "last_counters",
                        {"probe_steps": 5}, raising=False)
    built = keep_renderers(monkeypatch)
    scene = dict(config["scene"],
                 mesh_args={"n_lat": 8, "n_lon": 16, "ground_div": 4})
    ov = {"config": {"width": 16, "height": 16, "scene": scene},
          "traffic": {"frames_per_call": 1, "check_pixels": 8}}
    res = run_cell(bench, cell, 2 ** 31 + 17, 0.01, 1, "cpu", ov,
                   root=str(tmp_path))
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"gap_p50", "far_share"}
    (r,) = built
    assert {k[0] for k in r._integrators} == {"bounce"}
    (fn,) = [f for k, f in r._integrators.items() if k[2]]
    m = res["metrics"]
    assert m["waves_per_frame"]["value"] == fn.last_launched > 0
    assert m["probe_steps"] == {"value": 5, "unit": "steps"}

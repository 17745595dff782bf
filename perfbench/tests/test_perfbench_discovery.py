"""A configuration, a cell and a per-layer metric are added as new files
and new entries in BENCHMARK.json: nothing that exists changes."""

import json
import shutil

from perfbench.tests import tiny


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(tiny.ROOT / "perfbench", root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs"
                      / "rtp-jpeg-1080p-420-q75-ri4.json").read_text())
    cfg.update(width=48, height=32, quality=50, restart_interval=2)
    (root / "configs" / "tiny-q50-ri2.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "live.frame1.json").read_text())
    traffic.update(contents=3, clips=1, warm_calls=1, check_calls=2)
    (root / "traffic" / "live.frame3.json").write_text(json.dumps(traffic))
    (root / "layer_metrics" / "calls_seen.decode.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")

    bench = json.loads(json.dumps(tiny.BENCH))
    bench["configs"].append({"name": "tiny-q50-ri2", "source": "a test",
                             "file": "perfbench/configs/tiny-q50-ri2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "decode.tiny", "config":
                               "tiny-q50-ri2", "traffic": "live.frame3",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("decode_"):
            m["workloads"].append("decode.tiny")
    bench["per_layer"].append({"name": "calls_seen.decode", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "decode_Mpix_s",
                               "workloads": ["decode.tiny"]})

    c = tiny.cells.load_cell(bench, "decode.tiny", root)
    assert c.config["quality"] == 50 and c.traffic["contents"] == 3
    assert [m["name"] for m in c.per_layer] == ["calls_seen.decode"]
    res = tiny.run_cpu(c, traced=False)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"decode_Mpix_s", "decode_p95_ms",
                                   "setup_s"}
    traced = tiny.run_cpu(c, traced=True)
    assert traced["metrics"]["calls_seen.decode"]["value"] > 0
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts
             and ".cache" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_metric_without_workloads_follows_what_it_moves():
    bench = json.loads(json.dumps(tiny.BENCH))
    bench["per_layer"].append({"name": "device_idle.encode", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "encode_Mpix_s"})
    enc = tiny.cells.load_cell(bench, "encode.ri4.clip16")
    dec = tiny.cells.load_cell(bench, "decode.ri4.clip16")
    assert "device_idle.encode" in [m["name"] for m in enc.per_layer]
    assert "device_idle.encode" not in [m["name"] for m in dec.per_layer]

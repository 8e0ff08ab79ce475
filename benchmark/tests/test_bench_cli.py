"""The command as the checker runs it, where it must refuse to run: with
no CUDA card, and in a directory that holds only ``BENCHMARK.json`` and
the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _run(cwd, env=None):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    cmd = [sys.executable if c == "python3" else c for c in b["command"]]
    cell = b["workloads"][0]["name"]
    return subprocess.run(cmd + ["--workload", cell, "--seed",
                                 "3000000001", "--seconds", "1", "--trace",
                                 "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    if torch.cuda.is_available():
        out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    else:
        out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) <= set(json.load(f)) | {
                "vocabulary_levels"}
    for w in b["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert os.path.exists(os.path.join(BENCH, "workloads",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(BENCH, "checks",
                                           f"{w['name']}.json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]
    cells = {w["name"] for w in b["workloads"]}
    reports = {c: {m["name"] for m in b["end_to_end"]
                   if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2, c
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m
        for c in m.get("workloads", cells):
            assert m["moves"] in reports[c], (m["name"], c)

"""A narrow rehearsal of the benchmark's cells on the CPU: the v1 and v2
configurations at 8 joints and small widths, short traffic. The daemon
cells, whose generators and mixes wait for a later benchmark PR (see
PERF.md), are declared here as that PR would add them to
`BENCHMARK.json`, so that their code is rehearsed too."""

from __future__ import annotations

import copy

from benchmark.common import Cell, read_json, ROOT


def tiny_config(name):
    cfg = copy.deepcopy(read_json(ROOT / "benchmark" / "configs" / f"{name}.json"))
    cfg["net_opt"]["decoder"]["nhidden"] = 32
    cfg["net_opt"]["speech_encoder"].update(nhidden=16, speech_encoding_size=16)
    cfg["net_opt"]["style_encoder"].update(nhidden=24, style_encoding_size=8, example_length=32)
    cfg["train_opt"].update(batchsize=4, window=32)
    J = 8
    cfg["dataset"].update(njoints=J, pose_input_size=6 + J * 15 + 3, pose_output_size=6 + J * 15)
    return cfg


TINY_MIXES = {
    "v1.train": dict(corpus_frames=2000, takes=4, trace_replays=1),
    "v2.offline": dict(lines=6, min_s=0.5, max_s=2.5, bucket=64,
                       max_batch=4, first_poses=3, check_samples=12),
    "v1.serve": dict(rate=20.0, audio_pool=6, median_s=1.0, sigma=0.5, min_s=0.5, max_s=2.0,
                     style_pool=3, upload_pool=1, style_frames=64, style_window=32, bucket=64,
                     max_batch=4, trace_seconds=1, keep_replies=20, check_samples=20),
    "v2.stream": dict(sessions=2, max_sessions=4, first_poses=2, warm_pushes=2,
                      check_sessions=1, trace_seconds=1),
}


DAEMON_CELLS = {
    "workloads": [
        {"name": "v1.serve", "config": "zeggs_v1", "traffic": "poisson10_zipf19", "chips": 1},
        {"name": "v2.stream", "config": "zeggs_v2", "traffic": "live25_push500ms", "chips": 1}],
    "end_to_end": [
        {"name": "request_p95_ms", "unit": "ms", "workloads": ["v1.serve"]},
        {"name": "push_p95_ms", "unit": "ms", "workloads": ["v2.stream"]}],
    "per_layer": [
        {"name": "daemon_batch_rows.serve", "unit": "rows", "moves": "request_p95_ms",
         "workloads": ["v1.serve"]},
        {"name": "http_overhead_p50_ms.serve", "unit": "ms", "moves": "request_p95_ms",
         "workloads": ["v1.serve"]},
        {"name": "device_idle.serve", "unit": "%", "moves": "request_p95_ms",
         "workloads": ["v1.serve"]},
        {"name": "device_idle.stream", "unit": "%", "moves": "push_p95_ms",
         "workloads": ["v2.stream"]}],
}


def bench_with_daemon_cells():
    bench = read_json(ROOT / "BENCHMARK.json")
    for key, entries in DAEMON_CELLS.items():
        bench[key] = bench[key] + entries
    return bench


def tiny_cell(name):
    cell = Cell(name, bench_with_daemon_cells())
    cell.mix = dict(cell.mix, **TINY_MIXES.get(name, {}))
    return cell, tiny_config(cell.workload["config"])

"""The yardstick's arithmetic: the analytic train FLOPs against
`torch.utils.flop_counter.FlopCounterMode` over the reference's step, the
v1 step's 1.0955e12, the copied GRU-cell bound, and the open loop's
timing from each request's due time."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, http_client, inputs
from benchmark.common import ROOT, read_json
from benchmark.reference import model
from benchmark.tests.tiny import tiny_config


def counted_train_flops(cfg, device):
    B, T = cfg["train_opt"]["batchsize"], cfg["train_opt"]["window"]
    L = 2 * cfg["net_opt"]["style_encoder"]["example_length"]
    J = cfg["dataset"]["njoints"]
    nets = model.build_networks(cfg, device)
    arrays = {k: torch.randn((T + L + 8, *s), device=device)
              for k, s in inputs.track_shapes(J, cfg["dataset"]["audio_features"]).items()}
    arrays["root_rot"] = arrays["root_rot"] / torch.linalg.norm(arrays["root_rot"], dim=-1,
                                                                keepdim=True)
    ex_idx = np.tile(np.arange(L), (B, 1))
    batch = model.gather_batch(arrays, T, np.zeros(B, np.int64), ex_idx, np.full(B, L))
    if model.label_style(cfg):
        n = len(cfg["dataset"]["styles"])
        batch["style"] = torch.nn.functional.one_hot(torch.arange(B) % n, n).float()
    stats = inputs.stats_on(inputs.make_stats(cfg, 0), device)
    parents = inputs.skeleton(J)[1]
    loss_fn = model.make_loss_fn(cfg, stats, parents, 1 / 60)
    with FlopCounterMode(display=False) as counter:
        loss, _ = loss_fn(nets, batch, 0, None)
        loss.backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["zeggs_v1", "zeggs_v2"])
def test_train_flops_match_the_counter_at_a_small_width(name):
    cfg = tiny_config(name)
    assert flops.train_step_flops(cfg) == counted_train_flops(cfg, "cpu")


def test_v1_train_flops():
    cfg = read_json(ROOT / "benchmark" / "configs" / "zeggs_v1.json")
    assert flops.train_step_flops(cfg) == pytest.approx(1.0955e12, rel=5e-5)


def test_gru_cell_bound():
    assert flops.gru_cell_bound_s(64, 1024, 1024) * 1e6 == pytest.approx(12.02, abs=0.005)


def test_rollout_flops_per_frame():
    cfg = read_json(ROOT / "benchmark" / "configs" / "zeggs_v2.json")
    assert 37e6 < flops.rollout_flops_per_frame(cfg) < 39e6


class _Slow(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.4)
        body = json.dumps({"latency_ms": 400.0, "batch_size": 1}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_open_loop_times_each_request_from_its_due_time():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        plan = {"port": server.server_address[1], "start": time.monotonic() + 0.2,
                "threads": 1, "timeout": 10,
                "requests": [{"due": 0.0, "payload": {}}, {"due": 0.1, "payload": {}}]}
        first, second = http_client.open_loop(plan)
    finally:
        server.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()
    # one sender: the second request leaves when the first returns, ~0.3 s
    # late, and its latency counts that wait
    assert second["sent"] - second["due"] > 0.25
    assert second["done"] - second["due"] > 0.65
    assert first["done"] - first["due"] == pytest.approx(0.4, abs=0.15)


def test_idle_share_leaves_out_the_profilers_own_time():
    from benchmark.trace import Trace

    ms = 1_000_000
    # busy 0-40 and 60-100 ms; a buffer flush 35-70 ms covers the 40-60 gap
    tr = Trace(0.1, device=[("k", 0, 40 * ms), ("k", 60 * ms, 100 * ms)],
               host=[("Buffer Flush", 35 * ms, 70 * ms), ("bench:step", 0, 100 * ms)])
    assert tr.busy_s() == pytest.approx(0.08)
    assert tr.profiler_s() == pytest.approx(0.02)
    assert tr.idle_share() == pytest.approx(0.0, abs=1e-9)
    assert tr.idle_gaps() == []
    # a gap the flush covers only in part keeps the rest, named by the host
    tr.host[0] = ("Buffer Flush", 35 * ms, 50 * ms)
    assert tr.idle_share() == pytest.approx(100 * (1 - 0.08 / 0.09))
    assert tr.idle_gaps() == [["bench:step", pytest.approx(0.01)]]


def test_uniform_lengths_are_the_same_set_for_every_seed():
    s = inputs.uniform_lengths(20, 4.0, 12.0)
    assert len(s) == 20 and s.min() == pytest.approx(4.2) and s.max() == pytest.approx(11.8)
    assert s.mean() == pytest.approx(8.0)

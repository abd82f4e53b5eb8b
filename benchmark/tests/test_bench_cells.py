"""Every cell rehearsed on the CPU at a narrow width (`tiny.py`): a whole run
through `run.execute` (set-up, window, traced stretch, the check against
the reference) gives a result line of the contract's shape with
``correct`` true; and with the timed path broken underneath, once for each
fault the cell can have, ``correct`` comes out false. A run on one card
has no exchange between chips to leave out."""

import json

import numpy as np
import pytest
import torch

from benchmark.common import Clock, result_line
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CELLS = ["v1.train", "v2.offline", "v1.serve", "v2.stream"]
SEED = 2**31 + 977


def rehearse(name, trace=0, seconds=1.0):
    cell, cfg = tiny_cell(name)
    return cell, execute(cell, SEED, seconds, trace, "cpu", Clock(), config=cfg)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name, trace):
    cell, res = rehearse(name, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    line = json.loads(result_line(res["correct"], res["attempted"], res["failed"],
                                  res["metrics"], res["device"], res["checks"],
                                  res["breakdown"]))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run reads no device metric
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


# -- faults ------------------------------------------------------------------

def _unchanged_state(monkeypatch):
    from zeggs_tpu_torch.train import radam

    monkeypatch.setattr(radam.RAdam, "apply", lambda self, scalars, grads=None: None)


def _half_batch_train(monkeypatch):
    from zeggs_tpu_torch.data import device_dataset

    gather = device_dataset.DeviceCorpus.gather_batch

    def half(self, *a, **k):
        batch = gather(self, *a, **k)
        return {key: v[: v.shape[0] // 2] for key, v in batch.items()}

    monkeypatch.setattr(device_dataset.DeviceCorpus, "gather_batch", half)


def _wrap_rollout(monkeypatch, alter):
    from zeggs_tpu_torch.infer import generate

    rollout = generate.GesturePipeline.rollout_batch

    def broken(self, *a, **k):
        return alter(tuple(t.clone() for t in rollout(self, *a, **k)))

    monkeypatch.setattr(generate.GesturePipeline, "rollout_batch", broken)


def _frozen_rollout(out):
    # every frame the first: the step returns its state unchanged
    return tuple(t[:, :1].expand_as(t).contiguous() for t in out)


def _half_rows(out):
    B = out[0].shape[0]
    return tuple(torch.cat([t[: (B + 1) // 2], torch.zeros_like(t[(B + 1) // 2:])]) for t in out)


def _altered_answer(out):
    root_pos, root_rot, lpos, lrot = out
    lrot[:, 3:, 1] = lrot[:, 3:, 2].flip(-1)
    return root_pos + 2.0, root_rot, lpos, lrot


def _altered_push(monkeypatch):
    from zeggs_tpu_torch.infer import streaming

    push = streaming.StreamingSession.push

    def broken(self, audio):
        frames = push(self, audio)
        return {k: v + 1.0 for k, v in frames.items()}

    monkeypatch.setattr(streaming.StreamingSession, "push", broken)


def _frozen_push(monkeypatch):
    from zeggs_tpu_torch.infer import streaming

    push = streaming.StreamingSession.push

    def broken(self, audio):
        frames = push(self, audio)
        return {k: np.repeat(v[:1], len(v), axis=0) for k, v in frames.items()}

    monkeypatch.setattr(streaming.StreamingSession, "push", broken)


FAULTS = {
    ("v1.train", "state_unchanged"): _unchanged_state,
    ("v1.train", "half_batch"): _half_batch_train,
    ("v2.offline", "state_unchanged"): lambda mp: _wrap_rollout(mp, _frozen_rollout),
    ("v2.offline", "half_batch"): lambda mp: _wrap_rollout(mp, _half_rows),
    ("v2.offline", "answer_altered"): lambda mp: _wrap_rollout(mp, _altered_answer),
    ("v1.serve", "state_unchanged"): lambda mp: _wrap_rollout(mp, _frozen_rollout),
    ("v1.serve", "half_batch"): lambda mp: _wrap_rollout(mp, _half_rows),
    ("v1.serve", "answer_altered"): lambda mp: _wrap_rollout(mp, _altered_answer),
    ("v2.stream", "state_unchanged"): _frozen_push,
    ("v2.stream", "answer_altered"): _altered_push,
}


@pytest.mark.parametrize("name,fault", sorted(FAULTS), ids=lambda x: x)
def test_fault_is_caught(name, fault, monkeypatch):
    FAULTS[name, fault](monkeypatch)
    _, res = rehearse(name)
    assert not res["correct"], res["checks"]

"""The ``v2film.offline`` cell rehearsed on the CPU at a narrow width (the
FiLM configuration at `tiny.py`'s widths and `v2.offline`'s short
traffic): a whole run gives a result line with ``correct`` true, and with
the timed path broken underneath (`test_bench_cells.py`'s faults of an
offline cell) ``correct`` comes out false."""

import pytest

from benchmark.common import Cell, Clock
from benchmark.run import execute
from benchmark.tests.test_bench_cells import FAULTS, SEED
from benchmark.tests.tiny import TINY_MIXES, bench_with_daemon_cells, tiny_config

NAME = "v2film.offline"


def rehearse(trace=0, seconds=1.0):
    cell = Cell(NAME, bench_with_daemon_cells())
    cell.mix = dict(cell.mix, **TINY_MIXES["v2.offline"])
    return cell, execute(cell, SEED, seconds, trace, "cpu", Clock(),
                         config=tiny_config("zeggs_v2_film"))


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    cell, res = rehearse(trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        # a CPU run reads no device metric, and no device time
        assert set(res["metrics"]) == {"rollout_mfu.film_offline"}
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_caught(fault, monkeypatch):
    FAULTS["v2.offline", fault](monkeypatch)
    _, res = rehearse()
    assert not res["correct"], res["checks"]

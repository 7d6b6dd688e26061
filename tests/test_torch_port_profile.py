"""--profile_dir in the port: one torch.profiler trace a rank, of one epoch.

As the JAX trainer (trainer.py:419-421, 533): a run of 3 epochs traces
epoch 1 (epoch_start + 1) and a 1-epoch run epoch 0, around the step loop
only: the trace's train_step ranges are that epoch's steps and no others,
and the save cadence's sampling and checkpoint writes are not in it. A run
without the flag writes no trace. (Under torch.distributed.run each gloo
rank writes its own trace_rank{r}.json: tests/test_torch_port_ddp.py's
two-rank CLI run checks that.) The trace's summary (utils/profiling.summarize) has its window's wall time. The
port's StepTimer gives the JAX one's summary under the same mocked clock.
"""

import glob
import json
import os
import re

import pytest

from masked_diffusion_tpu.utils import profiling as jprofiling
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.utils import profiling
from tests.test_torch_port_train import _train_args
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401

_STEP = re.compile(r"^train_step epoch (\d+) step (\d+)$")


def _traced_steps(path):
    """(epoch, step) of every train_step range in the trace, and its summary."""
    tr = profiling.read_trace(path)
    steps = sorted({tuple(int(g) for g in m.groups()) for e in tr["events"]
                    if (m := _STEP.match(str(e.get("name", ""))))})
    return steps, tr


def _run(tmp_path, epochs, *extra):
    # the save cadence at the last epoch only
    args = _train_args(tmp_path / "run", "cpu", "--num_epochs", str(epochs),
                       "--save_images_epochs", str(epochs), *extra)
    assert port_cli.main(args) == 0


@pytest.mark.parametrize("epochs,traced", [(3, 1), (1, 0)])
def test_one_trace_of_one_epoch(tmp_path, capsys, epochs, traced):
    prof = tmp_path / "prof"
    _run(tmp_path, epochs, "--profile_dir", str(prof))
    out = capsys.readouterr().out
    stats = json.loads([ln for ln in out.splitlines() if ln.startswith("train_stats ")][-1]
                       .split(" ", 1)[1])
    assert stats["global_step"] == 2 * epochs
    assert os.listdir(prof) == ["trace_rank0.json"]
    steps, tr = _traced_steps(str(prof / "trace_rank0.json"))
    assert steps == [(traced, 0), (traced, 1)]
    # the step loop only: every operator lies inside the train_step ranges'
    # span (the cadence's sampling and checkpoint writes come after it)
    ranges = [e for e in tr["events"] if _STEP.match(str(e.get("name", "")))]
    begin = min(e["ts"] for e in ranges)
    end = max(e["ts"] + e["dur"] for e in ranges)
    ops = [e for e in tr["events"] if e.get("cat") == "cpu_op"]
    assert ops and all(begin <= e["ts"] and e["ts"] + e["dur"] <= end for e in ops)
    summary = tr["summary"]
    assert summary["wall_ms"] > 0 and summary["device_idle_share"] is None
    assert summary["device_busy_ms"] == 0 and summary["top_device"] == []


def test_no_flag_no_trace(tmp_path):
    _run(tmp_path, 1)
    assert not glob.glob(str(tmp_path / "**" / "trace_rank*.json"), recursive=True)


def test_step_timer_equals_jax(monkeypatch):
    clock = iter([0.0, 0.5, 0.75, 2.0, 2.0, 3.25, 10.0, 10.1])
    ticks = list(clock)
    summaries = []
    for mod in (profiling, jprofiling):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda it=it: next(it))
        timer = mod.StepTimer(capacity=4)
        for i in range(len(ticks)):
            if i == 4:
                timer.reset_epoch()
            timer.tick()
        summaries.append(timer.summary())
        assert mod.StepTimer().summary() == {}
    assert summaries[0] == summaries[1] and summaries[0]["steps_per_sec"] > 0


def test_in_flight_time_is_the_union_of_the_spans():
    """Queued collectives overlap: the time one is in flight counts once."""
    assert profiling._union_ms([(30.0, 40.0), (0.0, 10.0), (5.0, 20.0), (12.0, 15.0)]) == 0.03
    assert profiling._union_ms([]) == 0.0

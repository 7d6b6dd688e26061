"""tools/profile_train.py --compare: where two profiles' steps differ.

The profiling itself needs a card; the comparison reads the files it
writes, so it is held here on two small hand-made ones.
"""

import json

from masked_diffusion_tpu_torch.tools import profile_train


def _write(path, wall, kernels, ops, calls, extra_mode=False):
    rows = [{"mode": "log+indexing", "card": "card, 700 W", "wall_ms_per_step": wall,
             "device_busy_ms_per_step": 10.0, "idle_share_unprofiled": 0.5,
             "kernels_per_step": sum(kernels.values()),
             "host_launches_per_step": sum(calls.values()),
             "kernel_calls_per_step": kernels, "host_op_calls_per_step": ops,
             "host_calls_per_step": calls}]
    if extra_mode:
        rows.append({"mode": "linear+thresholding", "wall_ms_per_step": 1.0})
    with open(path, "w") as f:
        json.dump(rows, f)
    return str(path)


def test_compare_lists_the_calls_that_differ_largest_first(tmp_path, capsys):
    a = _write(tmp_path / "a.json", 100.0, {"gemm": 10, "add": 5}, {"aten::add_": 5},
               {"cudaLaunchKernel": 15}, extra_mode=True)
    b = _write(tmp_path / "b.json", 120.0, {"gemm": 10, "add": 9, "fill": 1},
               {"aten::add_": 9, "aten::fill_": 1}, {"cudaLaunchKernel": 20})
    (row,) = profile_train.compare(a, b)  # a mode in one file only is left out
    assert row["mode"] == "log+indexing"
    assert row["wall_ms_per_step"] == [100.0, 120.0]
    assert row["kernels_per_step"] == [15, 20]
    assert row["host_launches_per_step"] == [15, 20]
    # unchanged calls are not listed; the largest change comes first
    assert [(r["name"], r["a"], r["b"], r["b_minus_a"]) for r in row["kernels"]] == [
        ("add", 5, 9, 4), ("fill", 0.0, 1, 1)]
    assert [r["name"] for r in row["host_ops"]] == ["aten::add_", "aten::fill_"]
    assert row["host_calls"] == [{"name": "cudaLaunchKernel", "a": 15, "b": 20,
                                  "b_minus_a": 5}]

    assert profile_train.main(["--compare", a, b]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line) == row

"""On the card: the command itself, one short run of the triage cell,
prints a correct result line. Skipped without a card; run on a machine
with one by ``python -m pytest benchmark/tests/test_bench_card.py``."""

import json
import os
import subprocess
import sys

import pytest

from mosaicbench import harness as H


@pytest.mark.gpu
def test_triage_command_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "triage-8x4k",
         "--seed", str(2**41 + 17), "--seconds", "2", "--trace", "0"],
        cwd=H.ROOT, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frames_per_s", "batch_p95_ms",
                                    "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.gpu
@pytest.mark.parametrize("control, number, limit", [
    ("bf16_warp", "sum_rel", 1e-6), ("bf16_keypoints", "model_px", 0.25)])
def test_triage_controls_read_incorrect_on_the_card(card, control, number,
                                                    limit):
    """Each of the triage cell's lower-precision controls, at the cell's
    own size (at the CPU tests' cut size the program's own model error is
    as large as the keypoint control's), fails its layer's number."""
    from mosaicbench.controls import controls_for
    res, _ = H.run_cell("triage-8x4k", 2**37 + 3, 0.0, 0, card, {
        "traffic": {"warmup_rounds": 1},
        "patch": controls_for("triage-8x4k")[control]})
    assert not res["correct"]
    assert res["checks"][number]["value"] > limit

"""One short cell on the card, through the benchmark's command.  Skips
where torch sees no card; run on a machine with a card with
``python3 -m pytest -q --noconftest -m gpu portbench/tests``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs only on the card")


@pytest.mark.gpu
def test_a_short_cell_runs_correct_on_the_card(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "range-1080p-stream", "--seed", "2147483999",
                        "--seconds", "2", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=1200, env={**os.environ})
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["encode_mpix_s"]["value"] > 0

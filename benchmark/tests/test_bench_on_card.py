"""The controls at the cells' own sizes, on the card (marker ``cuda``; skipped
where there is none): on three seeds the port as each cell states it passes
the cell's limits, and the reference one precision below (fp8 products for
the bf16 cell, W4A4 for the W8A8 one) on the same rows fails them.

    python3 -m pytest --noconftest -m cuda benchmark/tests/test_bench_on_card.py -q
"""

import json
import subprocess
import sys

import pytest

from helpers import REPO

SEEDS = "7100001,7100002,7100003"


def _readings(cell):
    p = subprocess.run([sys.executable, "-m", "benchmark.harness.control", "--workload", cell,
                        "--seeds", SEEDS, "--seconds", "6"],
                       cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(line.split(" ", 1)[1]) for line in p.stdout.splitlines()
            if line.startswith("reading ")]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phi35v.eval.bf16", "qwen25vl7b.serve.w8a8"])
def test_control_fails_and_the_program_passes(card, cell):
    readings = _readings(cell)
    assert len(readings) == 3
    assert all(r.get("correct") for r in readings), readings
    assert all(r["controls"]["control"]["caught"] for r in readings), readings

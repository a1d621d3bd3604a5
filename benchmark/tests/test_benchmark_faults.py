"""A run with its timed path broken underneath reads `correct: false`.

Each case drives the rest of a run (the CPU rehearsal: no look for a chip,
narrow widths) with one fault planted, one for each fault the cell can
have: a decoded symbol altered where the decoder produces it (sweeps), a
step that leaves the parameters unchanged, and half of each batch left out
with the mean taken over the rest (training on one card: no exchange
between chips)."""

import json

import pytest

from benchmark import run


@pytest.mark.parametrize("cell,fault", [("sknn-sweeps", "altered_symbol"),
                                        ("dgcnn-sweeps", "altered_symbol"),
                                        ("sknn-train", "frozen"),
                                        ("sknn-train", "half_batch")])
def test_fault_reads_incorrect(cell, fault, capsys):
    rc = run.main(["--workload", cell, "--seed", "2147483777", "--seconds", "0.5",
                   "--trace", "0", "--rehearse", "--fault", fault])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_sound_run_reads_correct(capsys):
    rc = run.main(["--workload", "sknn-train", "--seed", "2147483777", "--seconds", "0.5",
                   "--trace", "0", "--rehearse"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]

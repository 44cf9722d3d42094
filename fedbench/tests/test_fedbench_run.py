"""Whole runs of every cell on the CPU, at tiny sizes: the harness with the
program's CPU path under it (the kernels' plain versions).  The CPU form is
for these tests only; the command itself refuses to run without a card.

A sound run comes out correct.  The control (in the llama cell the plain
reference with a float8 base put in the program's place, in the resnet
cell the program's bfloat16 path) and each fault planted under the timed
path come out not correct.
"""

import json

import pytest

from fedbench import run

TINY = {
    "mistral7b.lora_swa8k": {
        "config": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
                   "num_hidden_layers": 2, "vocab_size": 256, "sliding_window": 16},
        # The tiny size's own limit of grad1_diff (the cell's are set at full
        # size): the program reads 0.015-0.021 there, the float8 control
        # 0.142-0.147.
        "workload": {"seq_len": 48, "rows_per_party": 4,
                     "limits": {"grad1_gap": 0.05, "change_gap": 0.02, "grad1_diff": 0.05, "agg_mismatch": 0}},
    },
    "resnet18.hub4_b64": {
        "config": {"stage_sizes": [1, 1], "width": 8, "image_size": 8},
        "workload": {"batch": 8, "local_steps": 3, "images_per_party": 64, "traced_rounds": 2},
    },
}
FAULTS = ("fault.state_unchanged", "fault.half_batch", "fault.no_exchange", "fault.altered")
E2E = {"setup_s", "wire_mb_per_round"}  # with round_s.<kind>; peak_mem_gib.<kind> is the card's
KIND = {"mistral7b.lora_swa8k": "llama", "resnet18.hub4_b64": "resnet"}


def _run(capsys, cell, variant="program", trace=0):
    rc = run.main(["--workload", cell, "--seed", "3987654321", "--seconds", "1", "--trace", str(trace),
                   "--variant", variant], device="cpu", overrides=TINY[cell])
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-4000:]
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and captured.err.strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(capsys, cell):
    line = _run(capsys, cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == E2E | {f"round_s.{KIND[cell]}"} and line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("variant", ("control",) + FAULTS)
def test_control_and_faults_are_not_correct(capsys, cell, variant):
    line = _run(capsys, cell, variant)
    assert not line["correct"], line["checks"]


def test_int8_path_runs(capsys):
    """The program's own int8 base, a reading beside the control (it sets no
    limit): the run goes through and reads every number."""
    line = _run(capsys, "mistral7b.lora_swa8k", "control.int8")
    assert all(c["value"] == c["value"] for c in line["checks"].values()), line["checks"]
    assert line["checks"]["grad1_diff"]["value"] > 0


def test_traced_run_reads_the_spans(capsys):
    line = _run(capsys, "resnet18.hub4_b64", trace=1)
    assert line["correct"]
    assert set(line["metrics"]) == {"round.local_s.resnet", "round.exchange_s.resnet", "wire.send_ms.resnet",
                                     "agg.fold_ms.resnet"}


def test_no_card_no_result(capsys):
    assert run.main(["--workload", "resnet18.hub4_b64", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""

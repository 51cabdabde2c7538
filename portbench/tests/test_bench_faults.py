"""The comparison fails what it must: the timed path broken underneath (each
fault the cell can have) makes ``correct`` false; the control, the reference
in float8 in the program's place, reads far above the program."""
import pytest

from faults import FAULTS
from harness import cell as C

CASES = [("ls960h-train", "unchanged_state"), ("ls960h-train", "half_batch"),
         ("ls960h-transcribe-greedy", "altered_transcript"),
         ("wmt17-translate-beam5", "altered_translation"),
         ("wmt17-translate-beam5", "worse_candidates")]


def correct(outcome):
    return C.judge(outcome.checks) and outcome.failed == 0


@pytest.mark.parametrize("workload", ["ls960h-train", "ls960h-transcribe-greedy",
                                      "wmt17-translate-beam5"])
def test_sound_run_is_correct(tiny, workload):
    assert correct(C.run_kind(tiny(workload)))


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(tiny, workload, fault):
    with FAULTS[fault]():
        outcome = C.run_kind(tiny(workload))
    assert not correct(outcome), outcome.checks


@pytest.mark.parametrize("workload", ["ls960h-train", "ls960h-transcribe-greedy",
                                      "wmt17-translate-beam5"])
def test_control_reads_above_the_program(tiny, workload):
    cell = tiny(workload)
    cell.control = "fp8"
    outcome = C.run_kind(cell)
    assert any(outcome.controls[n] > 3 * max(c["value"], 1e-6)
               for n, c in outcome.checks.items()), (outcome.checks, outcome.controls)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ls960h-train", "ls960h-transcribe-greedy",
                                      "wmt17-translate-beam5"])
def test_control_fails_at_the_cell_size(card, workload):
    """On the card at the cell's own size: the control breaks a limit."""
    cell = C.make_cell(C.benchmark(), workload, 2**31 + 4242, 0.0, False, "cuda")
    cell.control = "fp8"
    outcome = C.run_kind(cell)
    assert any(outcome.controls[n] > c["limit"] for n, c in outcome.checks.items())

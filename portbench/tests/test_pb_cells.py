"""Small cells run end to end on the CPU (the program's plain versions):
sound runs are correct; the control and every fault a cell can have
make `correct` come out false."""

import pytest

from portbench.tests.faults import planted
from portbench.tests.helpers import run_tiny

CELLS = ('tiny_av.offline', 'tiny_video.live1')
# the faults each cell can have: one-frame decodes (live1) have no half
# of a batch to leave out, and no cell spans chips
FAULTS = [(c, f) for c in CELLS
          for f in ('stale_state', 'half_batch', 'altered_answer')
          if not (c.endswith('live1') and f == 'half_batch')]


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell, seed=2**31 + 101, seconds=1.5)
    assert out['correct'], out['compared']
    assert out['failed'] == 0 and out['attempted'] > 0
    assert all(c['value'] == 0 for c in out['compared'].values())
    assert list(out)[-1] == 'compared'


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    out = run_tiny(cell, seed=2**31 + 102, seconds=1.0, control=True)
    assert not out['correct'], out['compared']


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_fault_is_not_correct(cell, fault):
    with planted(fault):
        out = run_tiny(cell, seed=2**31 + 103, seconds=1.0)
    assert not out['correct'], out['compared']
    assert out['failed'] > 0


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reads_its_layers(cell):
    out = run_tiny(cell, seed=2**31 + 104, seconds=1.0, trace=True)
    assert out['correct']
    # on the CPU: the spans; the device metrics need the card
    assert any('ms' in k for k in out['metrics'])

"""The port's sanitizer rig (jsmpeg_tpu_torch/host/native/
sanitize_check.py) on the CPU: both flavours clean over the port's own
host code, the runner refusing a driver that reports (a heap overflow
under ASan+UBSan, a data race under TSan) and a build that fails, and
the CUDA half's parsing of compute-sanitizer's summaries and its refusal
without the tool.  The CUDA half itself runs on the card only."""

import pytest

from jsmpeg_tpu_torch.host.native import sanitize_check as sc

FAULTY = r'''
#include <cstdio>
#include <thread>
int shared = 0;
int main(int argc, char** argv) {
  int* a = new int[4];
  a[argc + 3] = 1;                     // one past the end
  std::thread t([] { shared++; });
  shared++;                            // races with the thread
  t.join();
  std::printf("%d %d\n", a[0], shared);
  delete[] a;
  return 0;
}
'''


@pytest.mark.parametrize('flavor', sorted(sc.FLAVORS))
def test_host_code_is_clean(flavor):
    """The driver reaches every part (the packed wire at F = 8 on 4
    threads and at F = 32 on 8, the sparse and dense wires, the serial
    parse and the I-picture seek, MP2 with its state carried, the TS
    demux three ways) on each fixture, with no report."""
    res = sc.check_host((flavor,))[flavor]
    assert len(res['runs']) == 3
    for line in res['runs']:
        fields = dict(kv.split('=') for kv in line.split(': ')[1].split())
        frames = {int(fields[k]) for k in ('packed_f8', 'packed_f32',
                                           'sparse', 'dense', 'serial')}
        assert len(frames) == 1 and frames.pop() >= 10, line
        assert int(fields['iframes']) >= 2
        assert int(fields['audio']) == 24
        assert int(fields['ts_rounds_with_events']) == 3


@pytest.mark.parametrize('flavor', sorted(sc.FLAVORS))
def test_runner_refuses_a_driver_that_reports(flavor, tmp_path):
    src = tmp_path / 'faulty.cpp'
    src.write_text(FAULTY)
    with pytest.raises(sc.SanitizerError, match=flavor):
        sc.build_and_run(str(tmp_path), flavor, [str(src)], [[]])


def test_runner_refuses_a_failed_build(tmp_path):
    src = tmp_path / 'broken.cpp'
    src.write_text('int main() { return undeclared; }\n')
    with pytest.raises(sc.SanitizerError, match='build failed'):
        sc.build(str(tmp_path), 'tsan', [str(src)])


def test_compute_sanitizer_summaries():
    memcheck = ('========= COMPUTE-SANITIZER\ncuda driver OK {}\n'
                '========= ERROR SUMMARY: 0 errors\n')
    assert sc._tool_summary('memcheck', memcheck) == {'errors': 0}
    assert sc._tool_summary('synccheck', '= ERROR SUMMARY: 3 errors') == \
        {'errors': 3}
    race = ('========= RACECHECK SUMMARY: 2 hazards displayed (1 error, '
            '1 warning)\n')
    assert sc._tool_summary('racecheck', race) == {
        'errors': 1, 'hazards': 2, 'warnings': 1}
    assert sc._tool_summary('memcheck', 'no summary') == {'errors': None}


def test_missing_compute_sanitizer_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(sc.shutil, 'which', lambda name: None)
    monkeypatch.setattr(sc, 'COMPUTE_SANITIZER_DEFAULT',
                        str(tmp_path / 'none'))
    with pytest.raises(sc.SanitizerError, match='compute-sanitizer'):
        sc.compute_sanitizer_path()


class _Run:
    def __init__(self, stdout='', stderr='', returncode=0):
        self.stdout, self.stderr, self.returncode = stdout, stderr, returncode


CLEAN = {'memcheck': '========= ERROR SUMMARY: 0 errors\n',
         'synccheck': '========= ERROR SUMMARY: 0 errors\n',
         'racecheck': '========= RACECHECK SUMMARY: 0 hazards displayed '
                      '(0 errors, 0 warnings)\n'}


def _fake_tools(monkeypatch, output):
    """check_cuda's world on the CPU: a card, a compute-sanitizer and
    built libraries that are not there, and `output(tool)` -> (stdout,
    stderr, rc) for each tool's run of the driver."""
    import torch

    from jsmpeg_tpu_torch.host.native import build_native
    from jsmpeg_tpu_torch.ops import kernels
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'card')
    monkeypatch.setattr(sc, 'compute_sanitizer_path', lambda: 'cs')
    monkeypatch.setattr(build_native, 'ensure_built', lambda: None)
    monkeypatch.setattr(kernels, 'ensure_built', lambda: None)
    runs = []

    def run(cmd, **kw):
        if cmd[1] == '--version':
            return _Run('NVIDIA (R) Compute Sanitizer\nVersion 2025.2.1\n')
        assert cmd[-1] == '--cuda-driver'
        assert kw['env']['PYTORCH_NO_CUDA_MEMORY_CACHING'] == '1'
        runs.append(cmd[2])
        return _Run(*output(cmd[2]))

    monkeypatch.setattr(sc.subprocess, 'run', run)
    return runs


def test_cuda_half_clean_tools(monkeypatch, tmp_path):
    runs = _fake_tools(monkeypatch, lambda tool: (
        sc.DRIVER_OK + ' {}\n', CLEAN[tool], 0))
    res = sc.check_cuda(log_dir=str(tmp_path))
    assert runs == list(sc.CUDA_TOOLS) == list(res)
    assert res['racecheck']['hazards'] == 0
    assert all(r['driver_ok'] and r['errors'] == 0 for r in res.values())
    assert (tmp_path / 'synccheck.txt').read_text().startswith(sc.DRIVER_OK)


def test_cuda_half_reports_fail_after_every_tool(monkeypatch, tmp_path):
    hazard = ('========= Error: Race reported between Write access at '
              'k+0x10\n========= RACECHECK SUMMARY: 1 hazard displayed '
              '(1 error, 0 warnings)\n')
    runs = _fake_tools(monkeypatch, lambda tool: (
        sc.DRIVER_OK + ' {}\n', hazard if tool == 'racecheck'
        else CLEAN[tool], 86 if tool == 'racecheck' else 0))
    with pytest.raises(sc.SanitizerError, match="racecheck") as e:
        sc.check_cuda(log_dir=str(tmp_path))
    assert runs == list(sc.CUDA_TOOLS)
    assert 'Race reported' in str(e.value)


def test_cuda_half_refuses_a_device_the_tool_does_not_support(monkeypatch,
                                                              tmp_path):
    """What compute-sanitizer prints on a machine where it cannot
    instrument the card: the rig stops at once and says nothing was
    checked."""
    runs = _fake_tools(monkeypatch, lambda tool: (
        '', '========= COMPUTE-SANITIZER\n========= Error: Device not '
        'supported. Please refer to the "Supported Devices" section of the '
        'sanitizer documentation\n========= ERROR SUMMARY: 1 error\n', 86))
    with pytest.raises(sc.SanitizerError,
                       match='does not support this device') as e:
        sc.check_cuda(log_dir=str(tmp_path))
    assert runs == ['memcheck']
    assert 'no kernel was checked' in str(e.value)
    assert '2025.2.1' in str(e.value)

"""The port stands alone: jsmpeg_tpu_torch, chip_smoke.py, k2_sweep.py
and the K3 mirror (tests/torch_k3_mirror.py) import neither JAX nor
anything of jsmpeg_tpu or tests/oracle, no module of the package executes
a file by its path, importing them has no side effects, and no
entry point (the decoders, the Player, the PPM writer, the CLI,
multi-stream serving, thumbnails, the tiled mesh decode, the
multi-process and elastic decodes, the robustness soak, the sanitizer
rig's CUDA half and its checked half) quietly runs on the CPU; importing
the port loads neither kernel library, the checked one least of all."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jsmpeg_tpu_torch.models.mp2 import MP2Decoder
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.parallel.streams import (MultiStreamDecoder,
                                               decode_streams_offline)
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.serve import serve
from jsmpeg_tpu_torch.sinks import PPMWriter
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_video
from jsmpeg_tpu_torch.thumbs import extract_iframe_planes

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'jsmpeg_tpu'}


def _port_files():
    return sorted((ROOT / 'jsmpeg_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'k2_sweep.py',
        ROOT / 'tests' / 'torch_k3_mirror.py']


def test_no_file_imports_jax_or_the_jax_package():
    """Every import statement, by its top-level module (so the
    `jsmpeg_tpu_torch` prefix is no false hit)."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f'{path.relative_to(ROOT)}:{node.lineno} {n}'
                    for n in names if n.split('.')[0] in FORBIDDEN
                    or n.startswith('tests.oracle')]
    assert not bad, bad
    assert len(_port_files()) > 20
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f'jsmpeg_tpu_torch/parallel/{m}.py'
            for m in ('tiles', 'multihost', 'elastic')} <= names
    assert {'jsmpeg_tpu_torch/fuzz_soak.py',
            'jsmpeg_tpu_torch/host/native/sanitize_check.py',
            'jsmpeg_tpu_torch/ops/kernels.py',
            'jsmpeg_tpu_torch/testing/spec.py',
            'jsmpeg_tpu_torch/testing/kernel_inputs.py'} <= names
    # the checked rig's code: the binding (ops/kernels.py) and the rig
    # (sanitize_check.py); neither reaches jax, jaxlib, jsmpeg_tpu or
    # tests.oracle through a string either (importlib, __import__,
    # subprocess code)
    for rel in ('jsmpeg_tpu_torch/ops/kernels.py',
                'jsmpeg_tpu_torch/host/native/sanitize_check.py'):
        text = (ROOT / rel).read_text()
        assert not re.search(r"""['"](jax|jaxlib|jsmpeg_tpu|tests\.oracle)"""
                             r"""(\.|['"])""", text), rel
        assert 'import_module' not in text and '__import__' not in text


# calls that execute a file by its path, whatever their module
PATH_LOADERS = {'spec_from_file_location', 'spec_from_loader',
                'module_from_spec', 'exec_module', 'load_module',
                'SourceFileLoader', 'SourcelessFileLoader', 'run_path',
                'load_source', 'exec', 'execfile'}


def test_no_package_module_executes_a_file_by_path():
    """No module of jsmpeg_tpu_torch loads or runs a file by its path
    (importlib's file loaders, runpy, exec): what the package runs, it
    imports by name from the package."""
    bad = []
    for path in sorted((ROOT / 'jsmpeg_tpu_torch').rglob('*.py')):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call):
                fn = node.func
                name = (fn.attr if isinstance(fn, ast.Attribute) else
                        fn.id if isinstance(fn, ast.Name) else None)
            elif isinstance(node, ast.ImportFrom) and node.module:
                name = next((a.name for a in node.names
                             if a.name in PATH_LOADERS), None)
            else:
                continue
            if name in PATH_LOADERS:
                bad.append(f'{path.relative_to(ROOT)}:{node.lineno} {name}')
    assert not bad, bad


def test_import_every_module_without_jax():
    """In a process where `jax` and `jsmpeg_tpu` cannot be imported,
    every module of the port, the two scripts and the K3 mirror import,
    start no thread and build nothing."""
    code = '\n'.join([
        'import sys, threading, importlib, pkgutil',
        "for m in ('jax', 'jaxlib', 'jsmpeg_tpu', 'tests.oracle'):",
        '    sys.modules[m] = None',
        'import jsmpeg_tpu_torch',
        "names = [m.name for m in pkgutil.walk_packages(",
        "    jsmpeg_tpu_torch.__path__, 'jsmpeg_tpu_torch.')]",
        'for n in names:',
        '    importlib.import_module(n)',
        'import chip_smoke, k2_sweep',
        'import tests.torch_k3_mirror',
        'from jsmpeg_tpu_torch.ops import kernels',
        'from jsmpeg_tpu_torch.host import native',
        'assert kernels._lib is None and native._lib is None',
        'assert kernels._checked is None',
        'from jsmpeg_tpu_torch.host.native import sanitize_check',
        'assert sanitize_check.CHECKED_DEVICE == "cuda"',
        'assert threading.active_count() == 1',
        'print(len(names))',
    ])
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 45


def test_decoder_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        MPEG1Decoder()
    with pytest.raises(RuntimeError, match='CUDA'):
        MPEG1Decoder({'device': 'cuda'})
    assert MPEG1Decoder({'device': 'cpu'}).device == torch.device('cpu')


def test_player_and_audio_without_device_need_cuda(monkeypatch):
    """The Player, the audio decoder's device mode and the PPM writer run
    on the card unless given the CPU; the exact audio mode stays on the
    host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (lambda: Player(b''), lambda: Player(b'', {'audio': False}),
                 lambda: Player(b'', {'device': 'cuda'}),
                 lambda: MP2Decoder(mode='device'),
                 lambda: MP2Decoder({'device': 'cuda'}, mode='device'),
                 lambda: PPMWriter('f%d.ppm')):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
    p = Player(b'', {'device': 'cpu'})
    assert p.device == p.video.device == torch.device('cpu')
    assert p.audio.mode == 'exact' and p.audio.device is None
    assert MP2Decoder({'device': 'cpu'}, mode='device').device == \
        torch.device('cpu')
    assert MP2Decoder().device is None


def _clip_ts(path, seed):
    es, chunks = encode_test_stream(48, 32, n_frames=3, seed=seed, gop=3)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    path.write_bytes(mux_video(v, 25.0))
    return es


def test_serving_and_thumbnails_without_device_need_cuda(monkeypatch,
                                                         tmp_path):
    """MultiStreamDecoder, decode_streams_offline, serve() and
    extract_iframe_planes run on the card unless given the CPU; serve()
    refuses before it starts a source."""
    es = _clip_ts(tmp_path / 'a.ts', 3)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (lambda: MultiStreamDecoder(2),
                 lambda: MultiStreamDecoder(2, device='cuda'),
                 lambda: decode_streams_offline([es]),
                 lambda: serve([str(tmp_path / 'a.ts')]),
                 lambda: extract_iframe_planes(es)):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
    dec = MultiStreamDecoder(2, device='cpu')
    assert dec.device == torch.device('cpu')
    assert len(decode_streams_offline([es], device='cpu')[0]) == 3
    stats = serve([str(tmp_path / 'a.ts')], device='cpu')
    assert stats['video_frames'] == [3] and stats['device'] == 'cpu'
    _, thumbs = extract_iframe_planes(es, device='cpu')
    assert len(thumbs) == 1 and thumbs[0].y.device.type == 'cpu'


def _cli(*args, env=None, module='jsmpeg_tpu_torch'):
    return subprocess.run([sys.executable, '-m', module, *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, **(env or {})})


def test_multi_input_cli_serve_and_thumbs_need_a_card(tmp_path):
    """The multi-input CLI, `python -m jsmpeg_tpu_torch.serve` and
    `python -m jsmpeg_tpu_torch.thumbs` exit non-zero naming CUDA without
    a card, and run with --device cpu."""
    a, b = tmp_path / 'a.ts', tmp_path / 'b.ts'
    _clip_ts(a, 4)
    _clip_ts(b, 5)
    no_card = {'CUDA_VISIBLE_DEVICES': ''}
    runs = ((['jsmpeg_tpu_torch', str(a), str(b), '-o',
              str(tmp_path / 'm%d.y4m')], '"video_frames": [3, 3]'),
            (['jsmpeg_tpu_torch.serve', str(a), str(b)],
             '"video_frames": [3, 3]'),
            (['jsmpeg_tpu_torch.thumbs', str(a), '-o',
              str(tmp_path / 't%d.png')], '1 thumbnails'))
    for (module, *args), says in runs:
        r = _cli(*args, env=no_card, module=module)
        assert r.returncode != 0 and 'CUDA' in r.stderr, module
        assert says not in r.stdout
        r = _cli(*args, '--device', 'cpu', module=module)
        assert r.returncode == 0, r.stderr[-2000:]
        assert says in r.stdout, module


def test_cli_selftest_needs_a_card_unless_given_the_cpu():
    r = _cli('--selftest', env={'CUDA_VISIBLE_DEVICES': ''})
    assert r.returncode != 0
    assert 'CUDA' in r.stderr and '"selftest"' not in r.stdout
    r = _cli('--device', 'cpu', '--selftest')
    assert r.returncode == 0, r.stderr
    assert '"selftest": "ok"' in r.stdout and '"device": "cpu"' in r.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device -> a non-zero exit and no result line; the same
    alone in a directory without the package."""
    env = {'CUDA_VISIBLE_DEVICES': ''}
    for cwd in (ROOT, tmp_path):
        script = ROOT / 'chip_smoke.py'
        if cwd == tmp_path:
            script = tmp_path / 'chip_smoke.py'
            script.write_text((ROOT / 'chip_smoke.py').read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env={**os.environ, **env})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_tiled_and_multi_process_decodes_need_a_card(monkeypatch,
                                                     tmp_path):
    """decode_tiled, decode_tiled_levels (over a mesh of cards, or the
    default mesh), decode_packed_multihost, decode_gops_elastic and the
    elastic worker run on the card unless given the CPU, and raise
    naming CUDA without one."""
    from jsmpeg_tpu_torch.host.mpeg1_parse import MPEG1Parser
    from jsmpeg_tpu_torch.parallel.elastic import decode_gops_elastic
    from jsmpeg_tpu_torch.parallel.mesh import make_mesh
    from jsmpeg_tpu_torch.parallel.multihost import decode_packed_multihost
    from jsmpeg_tpu_torch.parallel.tiles import (decode_tiled,
                                                 decode_tiled_levels)
    es, _ = encode_test_stream(48, 64, n_frames=3, seed=6, gop=3)
    (tmp_path / 's.es').write_bytes(es)
    p = MPEG1Parser()
    p.write(es)
    frames = [p.parse_frame(eof=True) for _ in range(3)]
    r = _cli('127.0.0.1', '9', str(tmp_path / 's.es'), str(tmp_path),
             env={'CUDA_VISIBLE_DEVICES': ''},
             module='jsmpeg_tpu_torch.parallel.elastic')
    assert r.returncode != 0 and 'CUDA' in r.stderr
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cards = make_mesh(1, 2, devices=['cuda:0', 'cuda:1'])
    for make in (lambda: decode_tiled(frames, 4, 3, cards),
                 lambda: decode_tiled_levels(es, cards),
                 lambda: decode_tiled_levels(es, make_mesh(1, 2)),
                 lambda: decode_packed_multihost(es),
                 lambda: decode_gops_elastic(es)):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
    two = make_mesh(1, 2, devices=['cpu', 'cpu:0'])
    assert len(decode_tiled(frames, 4, 3, two)) == 3
    assert len(decode_tiled_levels(es, two)) == 3
    assert decode_packed_multihost(es, devices=['cpu'])[1] == [0, 1, 2]
    counts, got = decode_gops_elastic(es, n_workers=1, device='cpu',
                                      timeout=120)
    assert counts == [3] and len(got) == 3


def test_soak_and_sanitizer_cuda_half_need_a_card(monkeypatch, tmp_path):
    """`python -m jsmpeg_tpu_torch.fuzz_soak` without --device and
    `python -m jsmpeg_tpu_torch.host.native.sanitize_check --cuda` (and
    its --cuda-driver) exit non-zero naming CUDA without a card; the
    soak runs with --device cpu.  In process, fuzz_soak.main, check_cuda
    and cuda_driver raise."""
    from jsmpeg_tpu_torch import fuzz_soak
    from jsmpeg_tpu_torch.host.native import sanitize_check
    log = str(tmp_path / 'soak.jsonl')
    no_card = {'CUDA_VISIBLE_DEVICES': ''}
    for module, args in (('jsmpeg_tpu_torch.fuzz_soak',
                          ['--seconds', '1', '--log', log]),
                         ('jsmpeg_tpu_torch.host.native.sanitize_check',
                          ['--cuda']),
                         ('jsmpeg_tpu_torch.host.native.sanitize_check',
                          ['--cuda-driver']),
                         ('jsmpeg_tpu_torch.host.native.sanitize_check',
                          ['--checked', '--seconds', '1'])):
        r = _cli(*args, env=no_card, module=module)
        assert r.returncode != 0 and 'CUDA' in r.stderr, (module, args)
        assert 'done:' not in r.stdout and 'OK' not in r.stdout
    r = _cli('--seconds', '1', '--seed', '3', '--log', log, '--device',
             'cpu', module='jsmpeg_tpu_torch.fuzz_soak')
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'done: ' in r.stdout and ', 0 failures' in r.stdout
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from jsmpeg_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, '_lib', None)
    monkeypatch.setattr(kernels, '_checked', None)
    for call in (lambda: fuzz_soak.main(['--seconds', '1', '--log', log]),
                 lambda: fuzz_soak.main(['--device', 'cuda', '--seconds',
                                         '1', '--log', log]),
                 sanitize_check.check_cuda, sanitize_check.cuda_driver,
                 sanitize_check.check_checked, kernels.bind_checked):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()

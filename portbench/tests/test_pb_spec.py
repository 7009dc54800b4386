"""BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration, a mix and a per-layer metric are found by name: adding
them is adding files."""

import json
import os
import re
import shutil

from portbench import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\t\n\r]{1,200}$')


def _names(b):
    yield from (c['name'] for c in b['configs'])
    for w in b['workloads']:
        yield from (w['name'], w['config'], w['traffic'])
    yield from (m['name'] for m in b['end_to_end'] + b['per_layer'])
    for c in b['configs']:
        yield from c['reduced']


def test_names_units_and_lines():
    b = spec.benchmark()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    for n in _names(b):
        assert NAME.match(n), n
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for text in ([c['source'] for c in b['configs']]
                 + [c['why'] for c in b['configs'] + b['workloads']]
                 + [m['layer'] for m in b['per_layer']] + b['command']):
        assert LINE.match(text), text
    names = [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(names) == len(set(names))
    assert os.path.getsize(os.path.join(spec.ROOT, 'BENCHMARK.json')) \
        < 64 * 1024


def test_every_cell_resolves():
    b = spec.benchmark()
    e2e = {m['name']: m for m in b['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    assert all(0.01 <= m['bound'] <= 0.25 for m in e2e.values())
    for w in b['workloads']:
        c = spec.cell(w['name'])
        assert w['chips'] == 1
        got = {m['name'] for m in c.end_to_end}
        assert 'setup_s' in got and len(got) >= 2 and c.per_layer
        assert spec.load(c.traffic).Cell
        for m in c.per_layer:
            assert m['moves'] in got
            assert callable(spec.reader(m['name']))
    for c in b['configs']:
        with open(os.path.join(spec.ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        assert c['file'].startswith('portbench/')
    for m in b['per_layer']:
        if m['name'].endswith('_roofline') or '_roofline.' in m['name']:
            assert m['unit'] == '%'


def test_additions_are_files(tmp_path):
    """A configuration, a mix and a metric added as files to a copy are
    found, and the new cell runs, with no file of the copy edited."""
    from portbench.run import run_cell
    from portbench.tests.helpers import DATA
    import time
    base = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    before = {p: p.read_bytes() for p in base.rglob('*') if p.is_file()}
    shutil.copy(os.path.join(DATA, 'configs', 'tiny_av.json'),
                base / 'configs' / 'added_cfg.json')
    mix = json.loads((base / 'traffic' / 'offline.json').read_text())
    mix.update(file_seconds=0.4, planned_fps=30, warm_files=1,
               sample_frames_per_file=2)
    (base / 'traffic' / 'added_mix.json').write_text(json.dumps(mix))
    (base / 'layer_metrics' / 'files_per_run.added.py').write_text(
        'def read(run):\n    return len(run.slots)\n')
    b = spec.benchmark()
    b['workloads'].append({'name': 'added_cfg.added_mix',
                           'config': 'added_cfg', 'traffic': 'added_mix',
                           'chips': 1, 'why': 'added as files'})
    b['end_to_end'][0].setdefault('workloads', []).append(
        'added_cfg.added_mix')
    b['per_layer'].append({'name': 'files_per_run.added', 'unit': 'files',
                           'better': 'higher', 'source': 'program_counter',
                           'layer': 'Player offline', 'moves': 'decode_fps',
                           'workloads': ['added_cfg.added_mix']})
    cell = spec.cell('added_cfg.added_mix', bench=b, base=str(base))
    assert cell.config['width'] == 64 and cell.traffic['file_seconds'] == 0.4
    assert [m['name'] for m in cell.per_layer] == ['files_per_run.added']
    out = run_cell(cell, 5, 0.5, True, 'cpu', time.monotonic(),
                   base=str(base))
    assert out['correct']
    assert out['metrics']['files_per_run.added']['value'] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p

"""The checked build of the port's kernels (csrc/checked.cuh, the rig
`python -m jsmpeg_tpu_torch.host.native.sanitize_check --checked`) as far
as the CPU can check it: the build command and where it goes, the binding
rules (no card, the product library already loaded, never a fallback),
that nothing but the rig names the checked library, the fault-record
decoder and the site table parsed from the sources, that every barrier of
kernel code goes through the epoch macros, that the product expansions of
the macros are the plain accesses, the two-poison coverage helper, the
negative controls' table, the rig's plumbing rehearsed with the plain
versions, and K3's mirror (tests/torch_k3_mirror.py, whose every index is
bounds-asserted) over the fuzz corpus's packed batches.  The checked
kernels themselves run on the card only (chip_smoke.py's s2_checked)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jsmpeg_tpu_torch import fuzz_soak
from jsmpeg_tpu_torch.demux import demux_to_es
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
from jsmpeg_tpu_torch.host.native import sanitize_check as sc
from jsmpeg_tpu_torch.models import mpeg1 as tm
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.testing import kernel_cases
from tests import torch_k3_mirror as k3m
from tests.test_torch_unpack import _assert_levels_equal, _jax_levels

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / 'jsmpeg_tpu_torch' / 'csrc'
HEADER = CSRC / 'checked.cuh'


def _code(path) -> str:
    """A source without its comments."""
    text = Path(path).read_text()
    text = re.sub(r'/\*.*?\*/', '', text, flags=re.S)
    return re.sub(r'//[^\n]*', '', text)


# ------------------------------------------------------------ the build

def test_checked_build_command_and_directory():
    """The checked build compiles the same sources with the product's
    flags plus -DJT_CHECKED -lineinfo (sm_90a kept) into a directory of
    its own; the product command and NVCC_FLAGS are unchanged."""
    assert kernels.NVCC_FLAGS == ['-gencode', 'arch=compute_90a,code=sm_90a',
                                  '-O3', '-std=c++17', '-Xcompiler', '-fPIC']
    src = kernels.SOURCES[1]
    product = kernels.build_command('nvcc', src, 'k.o')
    checked = kernels.build_command('nvcc', src, 'k.o', checked=True)
    assert product == (['nvcc'] + kernels.NVCC_FLAGS
                       + ['-Xptxas', '-v', '-c', src, '-o', 'k.o'])
    assert '-DJT_CHECKED' not in product and '-lineinfo' not in product
    assert '-DJT_CHECKED' in checked and '-lineinfo' in checked
    assert 'arch=compute_90a,code=sm_90a' in checked
    assert [a for a in checked if a not in ('-DJT_CHECKED', '-lineinfo')] \
        == product
    d, so, log = kernels._paths(True)
    assert (d, so, log) == (kernels.CHECKED_DIR, kernels.CHECKED_SO_PATH,
                            kernels.CHECKED_LOG_PATH)
    assert os.path.dirname(so) == d != kernels.BUILD_DIR
    assert os.path.basename(so) == 'libjsmpeg_kernels_checked.so'
    assert os.path.dirname(d) == kernels.BUILD_DIR
    assert kernels._paths(False) == (kernels.BUILD_DIR, kernels.SO_PATH,
                                     kernels.LOG_PATH)
    # both builds go stale when the header changes
    assert str(HEADER) in kernels.HEADERS


def test_bind_checked_needs_a_card(monkeypatch):
    monkeypatch.setattr(kernels, '_lib', None)
    monkeypatch.setattr(kernels, '_checked', None)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        kernels.bind_checked()
    assert kernels._lib is None and kernels._checked is None


def test_bind_checked_refuses_once_the_product_library_is_loaded(
        monkeypatch):
    product = object()
    monkeypatch.setattr(kernels, '_lib', product)
    monkeypatch.setattr(kernels, '_checked', None)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(RuntimeError, match='product kernel library'):
        kernels.bind_checked()
    assert kernels._lib is product and kernels._checked is None


class _FakeFn:
    def __init__(self, result=0):
        self.result, self.calls = result, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


class _FakeCheckedLib:
    """The checked library's C interface, recording its calls."""

    def __init__(self):
        for name in ('jt_dequant_idct', 'jt_dequant_idct_compact',
                     'jt_mc_combine', 'jt_mc_combine_grid',
                     'jt_mc_combine_flag_words', 'jt_mc_combine_band',
                     'jt_wire_unpack_launches', 'jt_wire_unpack',
                     'jt_checked_fault', 'jt_checked_reset',
                     'jt_checked_shadow', 'jt_checked_seed',
                     'jt_checked_inject'):
            setattr(self, name, _FakeFn())
        self.jt_checked_fault_words = _FakeFn(
            kernels.FAULT_DTYPE.itemsize // 4)


def test_bind_checked_binds_the_checked_library_and_never_falls_back(
        monkeypatch):
    """bind_checked builds and loads the checked library only (never the
    product one), makes it the library every launcher uses, hands it the
    checker's buffer, and a second call returns the same binding; a
    checked launcher given CPU tensors raises (no plain fallback)."""
    built, loaded = [], []
    fake = _FakeCheckedLib()
    monkeypatch.setattr(kernels, '_lib', None)
    monkeypatch.setattr(kernels, '_checked', None)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(kernels, 'ensure_built', lambda checked=False: (
        built.append(checked), f'lib{checked}.so')[1])
    monkeypatch.setattr(kernels.ctypes, 'CDLL',
                        lambda path: (loaded.append(path), fake)[1])
    monkeypatch.setattr(kernels, '_shadow_buffer',
                        lambda n: torch.empty(16, dtype=torch.uint8))
    chk = kernels.bind_checked()
    assert built == [True] and loaded == ['libTrue.so']
    assert kernels.lib() is fake and kernels._checked is chk
    assert chk.lib is fake and len(fake.jt_checked_shadow.calls) == 1
    assert kernels.bind_checked() is chk and built == [True]
    assert set(chk.launches) == set(kernels.CHECKED_FORMS)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dequant_idct_cuda(torch.zeros((1, 6, 64), dtype=torch.int16))
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dequant_idct_compact_cuda(
            torch.zeros((1, 64), dtype=torch.int16),
            torch.zeros(1, dtype=torch.int32), None, None, None, None, 6)
    assert not fake.jt_dequant_idct.calls and not any(chk.launches.values())
    assert not fake.jt_dequant_idct_compact.calls


def test_only_the_rig_names_the_checked_library():
    """No module of the port other than ops/kernels.py (the binding) and
    the rig (host/native/sanitize_check.py) names the checked library or
    binds it; the main path's modules never do."""
    names = ('bind_checked', 'CHECKED_SO_PATH', 'libjsmpeg_kernels_checked',
             'checked=True', 'JT_CHECKED', 'CheckedFault')
    allowed = {'ops/kernels.py', 'host/native/sanitize_check.py'}
    pkg = ROOT / 'jsmpeg_tpu_torch'
    bad = [f'{p.relative_to(pkg)}: {n}' for p in pkg.rglob('*.py')
           if p.relative_to(pkg).as_posix() not in allowed
           for n in names if n in p.read_text()]
    assert not bad, bad
    text = (pkg / 'host/native/sanitize_check.py').read_text()
    assert 'bind_checked()' in text


def test_checked_rig_without_a_card_exits_naming_it():
    r = subprocess.run(
        [sys.executable, '-m', 'jsmpeg_tpu_torch.host.native.sanitize_check',
         '--checked', '--seconds', '1'], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert r.returncode != 0
    assert 'CUDA' in r.stderr and '"checked"' not in r.stdout


# ------------------------------------------------- the header and sites

def test_kinds_follow_the_header_enum():
    enum = re.search(r'enum Kind : int \{(.*?)\};', _code(HEADER), re.S)[1]
    names = [n.split('=')[0].strip() for n in enum.split(',') if n.strip()]
    assert names[-1] == 'kKinds'
    snake = [re.sub(r'(?<!^)(?=[A-Z])', '_', n[1:]).lower()
             for n in names[:-1]]
    assert tuple(snake) == kernels.KINDS
    assert set(kernels.CATEGORY) == set(kernels.KINDS[1:])
    assert set(kernels.CATEGORY.values()) == {'faults', 'hazards',
                                              'flag_faults'}
    # jt::Fault: count[kKinds] claimed kind site block thread other index
    # extent, laid out as FAULT_DTYPE
    fault = re.search(r'struct Fault \{(.*?)\};', _code(HEADER), re.S)[1]
    assert re.sub(r'\s+', ' ', fault).strip() == (
        'unsigned count[kKinds]; unsigned claimed; int kind, site, block, '
        'thread, other; long long index, extent;')
    assert kernels.FAULT_DTYPE.itemsize == 4 * (len(kernels.KINDS) + 6) + 4 \
        + 16


def test_product_expansions_are_the_plain_accesses():
    """Built without JT_CHECKED every macro is the access or barrier it
    stands for: the product kernels compile as before the header."""
    product = _code(HEADER).split('#ifndef JT_CHECKED')[1].split('#else')[0]
    defs = dict(re.findall(r'#define (\w+(?:\([^)]*\))?)[ \t]*(.*)',
                           product))
    assert defs == {
        'JT_SYNCTHREADS()': '__syncthreads()',
        'JT_SYNCWARP()': '__syncwarp()',
        'JT_OK(i, extent)': 'true',
        'JT_OK_N(i, n, extent)': 'true',
        'JT_SH_LD(a, i, extent)': '(a)[i]',
        'JT_SH_ST(a, i, extent, v)': '((a)[i] = (v))',
        'JT_SH_OK(a, i, n, extent, access)': 'true',
        'JT_FLAG(cond, kind)': '((void)0)',
        'JT_DELAY(tag)': '((void)0)',
        'JT_INJECT(id)': 'false',
        'JT_INJECT_AT(id, where)': 'false',
        'JT_BEGIN(role)': '((void)0)',
        'JT_STORED()': '((void)0)',
        'JT_PUBLISHING(n)': '((void)0)',
        'JT_WAITED(wk, r0, r1, mb_h)': '((void)0)',
        'JT_READ_ROW(frame, row, mb_h)': 'true',
        'JT_SPIN_OUT(escape)': '__trap()',
        'JT_SPIN_SCALE(n)': '(n)',
        'JT_ARG(decl)': '',
        'JT_PASS(expr)': ''}
    k2 = _code(CSRC / 'mc_combine.cu')
    assert '#define JT_K2_SRC_OK(s, at, n, w) true' in k2


@pytest.mark.parametrize('name', ['dequant_idct.cu', 'mc_combine.cu',
                                  'wire_unpack.cu'])
def test_every_barrier_goes_through_the_epoch_macros(name):
    """No kernel source spells a bare __syncthreads() / __syncwarp(), so
    the checked build's epochs see every barrier; each includes the
    header under its own JT_FILE."""
    code = _code(CSRC / name)
    assert not re.search(r'\b__sync(threads|warp)\s*\(', code), name
    assert re.search(r'JT_SYNC(THREADS|WARP)\(\)', code)
    assert '#include "checked.cuh"' in code
    fid = int(re.search(r'#define JT_FILE (\d+)', code)[1])
    assert kernels.SITE_FILES[fid] == name


def test_site_table_ids_are_unique_and_on_real_lines():
    table = kernels.site_table()
    assert table
    by_start = {}
    for sid, site in table.items():
        fid, line = sid >> 16, sid & 0xFFFF
        assert kernels.SITE_FILES[fid] == site.file
        lines = (CSRC / site.file).read_text().split('\n')
        assert site.macro + '(' in lines[site.line - 1], site
        assert site.line <= line and line - site.line < 12, site
        assert site.function != '?', site
        by_start.setdefault((site.file, site.line), set()).add(sid)
    # every call of a checker macro in the sources is in the table
    for fid, name in kernels.SITE_FILES.items():
        for i, ln in enumerate((CSRC / name).read_text().split('\n')):
            if ln.lstrip().startswith(('#', '//')):
                continue
            for m in re.finditer(r'\b(JT_[A-Z0-9_]+)\(', ln):
                if m[1] not in ('JT_ARG', 'JT_PASS', 'JT_SPIN_SCALE',
                                'JT_CHECKED_EXPORTS'):
                    assert ((fid << 16) | (i + 1)) in table, (name, i + 1)
    functions = {s.function for s in table.values()}
    assert {'dequant_idct_kernel', 'frame_loop_kernel', 'stage_issue',
            'publish', 'wait_rows', 'look_back', 'scatter_mb',
            'write_kernel', 'scan_kernel'} <= functions


def test_fault_record_decodes_to_kernel_kind_and_site():
    table = kernels.site_table()
    site_id, site = next((sid, s) for sid, s in sorted(table.items())
                         if s.function == 'scatter_mb'
                         and s.macro == 'JT_SH_ST')
    rec = np.zeros(1, kernels.FAULT_DTYPE)[0]
    rec['count'][kernels.KINDS.index('waw')] = 24
    rec['claimed'] = 1
    rec['kind'] = kernels.KINDS.index('waw')
    rec['site'] = site_id
    rec['block'], rec['thread'], rec['other'] = 0, 1, 0
    rec['index'], rec['extent'] = 1026, 2
    got = kernels.decode_fault(rec, 3, table)
    assert got['kernel'] == 'wire_unpack' and got['kind'] == 'waw'
    assert got['where'] == f'wire_unpack.cu:{site.line}'
    assert got['function'] == 'scatter_mb' and got['counts'] == {'waw': 24}
    for part in ('wire_unpack', 'waw', f'wire_unpack.cu:{site.line}',
                 'scatter_mb', 'other thread 0'):
        assert part in got['message'], got['message']
    # three records back to back as jt_checked_fault copies them
    raw = np.zeros(3 * kernels.FAULT_DTYPE.itemsize // 4, np.int32)
    recs = raw.view(kernels.FAULT_DTYPE)
    recs[2] = rec
    assert [r['claimed'] for r in recs] == [0, 0, 1]
    # a site the table lacks still names its file and line
    rec['site'] = (2 << 16) | 9999
    assert kernels.decode_fault(rec, 2, table)['where'] == \
        'mc_combine.cu:9999'


def test_every_injection_has_a_site_and_an_expected_kind():
    table = kernels.site_table()
    functions = {s.function for s in table.values()}
    assert sorted(kernels.INJECTIONS) == [1, 2, 3, 4, 5, 6, 7]
    for inj, spec in kernels.INJECTIONS.items():
        name = next(n for f, n in kernels.SITE_FILES.items()
                    if kernels.FILE_KERNEL[f] == spec.kernel)
        code = _code(CSRC / name)
        plants = re.findall(rf'JT_INJECT(?:_AT)?\({inj}\b', code)
        assert len(plants) == 1, (inj, plants)
        others = [n for n in kernels.SITE_FILES.values() if n != name]
        assert not any(re.search(rf'JT_INJECT(?:_AT)?\({inj}\b',
                                 _code(CSRC / o)) for o in others)
        assert spec.kinds and set(spec.kinds) <= set(kernels.KINDS[1:]) | {
            'unwritten'}
        assert spec.functions and set(spec.functions) <= functions, spec
        assert inj in sc.INJECTION_CASES


def test_k2_form_is_the_entry_points_rule():
    assert kernels.k2_form(1, None, None) == 'mc_combine.one_stream'
    assert kernels.k2_form(4, None, None) == 'mc_combine.segmented'
    assert kernels.k2_form(1, torch.zeros(1), None) == 'mc_combine.segmented'
    assert kernels.k2_form(2, None, object()) == 'mc_combine.band'
    assert set(sc.MAIN_PATH_FORMS) <= set(kernels.CHECKED_FORMS)


# -------------------------------------------------------- the rig's parts

@pytest.mark.parametrize('dtype', [torch.int16, torch.bool, torch.int32,
                                   torch.uint8])
def test_unwritten_counts_bytes_no_run_wrote(dtype):
    """Two runs whose outputs start as the two poisons: the bytes that
    differ are the ones neither run wrote."""
    shape = (3, 5, 7)
    runs = []
    for poison in sc.POISONS:
        t = torch.empty(shape, dtype=dtype)
        t.view(torch.uint8).fill_(poison)
        t[0] = 1          # written
        t[2, :2] = 0      # written
        runs.append([t, torch.zeros(4, dtype=dtype)])
    item = torch.empty((), dtype=dtype).element_size()
    assert sc.unwritten(*runs) == (5 * 7 + 3 * 7) * item
    assert sc.unwritten([runs[0][0]], [runs[0][0]]) == 0
    # the bytes themselves, poison kept (a bool's clone may rewrite them)
    raw = sc.raw_bytes(runs[0][0])
    assert raw.dtype == torch.uint8 and raw.numel() == 3 * 5 * 7 * item
    assert int((raw == sc.POISONS[0]).sum()) == (5 * 7 + 3 * 7) * item


def test_checked_rig_plumbing_on_the_cpu(monkeypatch):
    """The rig's six parts in order on the CPU, the kernels swapped for
    their plain versions behind a stand-in for the checked binding (the
    device's own reports can only come from the card): every case runs,
    poisoned both ways and perturbed, the main stream's frames equal the
    CPU's, the K2/K3 cases of `testing.kernel_cases` and K2 on
    poisoned uncoded residuals, the soak, the seven controls (none can
    report here, so the summary is not ok) and the summary's keys."""
    from jsmpeg_tpu_torch.models.mpeg1 import unpack_wires_ref
    from jsmpeg_tpu_torch.ops.frame import decode_frames_ref, mc_combine_ref
    from jsmpeg_tpu_torch.ops.idct import (dequant_idct_compact_ref,
                                           dequant_idct_ref)

    class Stand:
        poison, seed, inject = None, 0, 0
        launches = dict.fromkeys(kernels.CHECKED_FORMS, 0)
        faults = dict.fromkeys(kernels.KINDS[1:], 0)

    stand = Stand()
    poisons = []

    def counted(form, fn):
        def launch(*a, **k):
            poisons.append(stand.poison)
            out = fn(*a, **k)
            stand.launches[form(*a, **k) if callable(form) else form] += 1
            return out
        return launch

    monkeypatch.setattr(kernels, 'dequant_idct_cuda', counted(
        lambda x, *a, premultiplied=False: 'dequant_idct.premultiplied'
        if premultiplied else 'dequant_idct.levels',
        lambda x, *a, premultiplied=False: dequant_idct_ref(
            x, *a, premultiplied=premultiplied)))
    monkeypatch.setattr(kernels, 'mc_combine_cuda', counted(
        lambda c, f, r, m, n_seg=1, seg=None, band=None: kernels.k2_form(
            n_seg, seg, band),
        lambda c, f, r, m, n_seg=1, seg=None, band=None: (
            decode_frames_ref(c, f, r, m, n_seg, seg) if band is None else
            [g[None] for g in mc_combine_ref(c, f, r[0], m[0], n_seg, seg,
                                             band)])))
    monkeypatch.setattr(kernels, 'dequant_idct_compact_cuda', counted(
        'dequant_idct.compact', dequant_idct_compact_ref))
    monkeypatch.setattr(kernels, 'wire_unpack_cuda',
                        counted('wire_unpack', unpack_wires_ref))
    monkeypatch.setattr(kernels, 'bind_checked', lambda: stand)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda *a: 'cpu')
    monkeypatch.setattr(torch.cuda, 'empty_cache', lambda: None)
    monkeypatch.setattr(sc, 'CHECKED_DEVICE', 'cpu')
    monkeypatch.setattr(sc, 'MAIN_STREAM', dict(width=64, height=48,
                                                n_frames=8, seed=3, gop=4))
    for k, v in dict(W=64, H=48, BATCH=4, N_FRAMES=8, GOP=4,
                     K3_OFF_TILE_MB=13, K3_CHECK_FRAMES=2, K3_DENSE_FRAMES=1,
                     K2_CHECK_FRAMES=2, K2_SEG_FRAMES=[2, 0, 1, 1],
                     K2_BAND_MB_H=5).items():
        monkeypatch.setattr(kernel_cases, k, v)
    monkeypatch.setattr(sc, '_slowdown', lambda es: {})
    res = sc.check_checked(seconds=1, seed=1300, perturb=2)
    n_driver = len(sc.driver_cases(np.random.default_rng(sc.DRIVER_SEED),
                                   'cpu'))
    assert res['cases'] == n_driver + len(res['kernel_cases']['cases'])
    assert not res['mismatches'] and not res['perturbed']
    assert res['unwritten'] == 0 and not res['reports']
    assert [r['frames_equal'] for r in res['main_path']['runs']] == [8, 8]
    assert res['soak']['iterations'] >= 1 and res['soak']['failures'] == 0
    assert res['injections_reported'] == '0/7' and not res['ok']
    assert {'K2 uncoded residuals 0x7fffffff',
            'K2 uncoded residuals -0x80000000'} <= set(
        res['kernel_cases']['cases'])
    assert set(sc.POISONS) <= set(poisons)
    for key in ('faults', 'hazards', 'flag_faults', 'unwritten',
                'perturbed_mismatches', 'checked_launches',
                'injections_reported', 'build_s'):
        assert key in res
    assert all(stand.launches[f] for f in kernels.CHECKED_FORMS)


# ------------------------------------------ K3's mirror over the corpus

def _corpus_batches(n_fixtures: int = 6):
    """Packed batches of the fuzz corpus: fuzz_soak's fixtures, clean and
    corrupted in each of its six modes, demuxed and parsed by the port's
    C++ parser at batches of 4 and 8 frames."""
    out = []
    for seed in range(n_fixtures):
        rng = np.random.default_rng(4000 + seed)
        es, ts = fuzz_soak.fixture(rng)
        streams = [es] + [demux_to_es(fuzz_soak.corrupt(ts, rng, m))
                          for m in fuzz_soak.MODES]
        for k, data in enumerate(streams):
            p = NativeMPEG1Parser()
            p.write(data)
            for _ in range(4):
                b = p.parse_batch(4 if k % 2 else 8, eof=True)
                if not isinstance(b, dict):
                    break
                if 'sp_pos' in b and b['n']:
                    out.append((f'fixture {seed} stream {k}', b,
                                p.seq.mb_size))
    return out


def test_mirror_bounds_hold_over_the_fuzz_corpus():
    """Every packed batch of the corpus through the K3 mirror at the
    kernel's tiles and at tiles of 8 (in a random interleaving): no index
    outside its region, and the levels equal the plain version's and
    jsmpeg_tpu's."""
    batches = _corpus_batches()
    assert len(batches) >= 20
    rng = np.random.default_rng(5)
    for name, b, n_mb in batches:
        buf, n_blk, n_runs, wide, n_pairs, n_esc = tm.build_fused_buffer(
            b, n_mb)
        sizes = (b['n'], n_mb, n_runs, wide, n_pairs, n_esc, n_blk)
        wires = torch.as_tensor(buf[None])
        want = tm.unpack_wires_ref(wires, *sizes)
        _assert_levels_equal(tm.levels_dense(want), _jax_levels(buf, sizes),
                             f'{name} jax')
        for tile, order in ((k3m.K3_TILE, None), (8, rng)):
            _assert_levels_equal(
                k3m.wire_unpack_mirror(wires, *sizes, tile=tile, rng=order),
                want, f'{name} mirror tile {tile}')


def test_mirror_asserts_an_index_outside_its_region():
    """The mirror's bounds assertion fires: a wire cut one byte short of
    its sizes, and a record slot past the records (negative control of
    the CPU twin)."""
    name, b, n_mb = _corpus_batches(1)[0]
    buf, n_blk, n_runs, wide, n_pairs, n_esc = tm.build_fused_buffer(b, n_mb)
    sizes = (b['n'], n_mb, n_runs, wide, n_pairs, n_esc, n_blk)
    with pytest.raises(AssertionError, match='sizes give'):
        k3m.wire_unpack_mirror(torch.as_tensor(buf[None, :-1]), *sizes)
    with pytest.raises(AssertionError, match='outside'):
        k3m._inside(torch.tensor([3, 9]), 0, 9, 'run record')
    k3m._inside(torch.tensor([0, 8]), 0, 9, 'run record')

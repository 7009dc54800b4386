"""Build, bind and launch the hand-written CUDA kernels.

Sources live in `jsmpeg_tpu_torch/csrc/*.cu` with a plain C interface.
At first CUDA use each source compiles with its own `nvcc` process (all
started together) for `sm_90a`, and the objects link into
`build/jsmpeg_tpu_torch/libjsmpeg_kernels.so` at the checkout root,
loaded with ctypes.  The build reruns when a source is newer than the
library; a missing `nvcc` or a failed build raises.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current stream, raises on a
non-zero `cudaGetLastError()`, and adds one to its entry in `launches`.
There is no fallback: the plain versions run only on CPU tensors, in the
callers (ops/idct.py, ops/frame.py, models/mpeg1.py).

The checked build (csrc/checked.cuh): the same three sources compiled with
`-DJT_CHECKED -lineinfo` into `build/jsmpeg_tpu_torch/checked/
libjsmpeg_kernels_checked.so` (`build(checked=True)`, same lock and
freshness rule).  Only `bind_checked()` loads it, in a process that has
not loaded the product library; from then on every launcher in that
process runs the checked kernels and, after each launch, synchronizes,
reads the fault records and raises `CheckedFault` naming the kernel, the
kind and `file:line` (`site_table()`).  `Checked` also holds the poison
byte, the perturbation seed and the negative control of the launches to
come, and counts checked launches by kernel and form.  The rig is
`python -m jsmpeg_tpu_torch.host.native.sanitize_check --checked`.

  python -m jsmpeg_tpu_torch.ops.kernels      # build and print the path
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, 'csrc')
SOURCES = [os.path.join(CSRC, n)
           for n in ('dequant_idct.cu', 'mc_combine.cu', 'wire_unpack.cu')]
HEADERS = [os.path.join(CSRC, 'checked.cuh')]
BUILD_DIR = os.path.join(os.path.dirname(PKG), 'build', 'jsmpeg_tpu_torch')
SO_PATH = os.path.join(BUILD_DIR, 'libjsmpeg_kernels.so')
LOG_PATH = os.path.join(BUILD_DIR, 'kernels_build.log')
CHECKED_DIR = os.path.join(BUILD_DIR, 'checked')
CHECKED_SO_PATH = os.path.join(CHECKED_DIR, 'libjsmpeg_kernels_checked.so')
CHECKED_LOG_PATH = os.path.join(CHECKED_DIR, 'kernels_build.log')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC']
CHECKED_FLAGS = ['-DJT_CHECKED', '-lineinfo']
NVCC_DEFAULT = '/usr/local/cuda/bin/nvcc'   # the toolkit's default prefix

# kernel launches since the last reset_launches(), by kernel name, and
# K1's by form (each K1 launch counts in both)
launches = {'dequant_idct': 0, 'mc_combine': 0, 'wire_unpack': 0}
k1_forms = {'dequant_idct.compact': 0, 'dequant_idct.levels': 0,
            'dequant_idct.premultiplied': 0}

_lib = None


def reset_launches() -> None:
    for counts in (launches, k1_forms):
        for k in counts:
            counts[k] = 0


def nvcc_path() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((os.path.join(home, 'bin', 'nvcc') if home else None),
                 shutil.which('nvcc'), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'of jsmpeg_tpu_torch cannot be built')


def _paths(checked: bool) -> tuple:
    """(directory, library, build log) of the product or checked build."""
    return ((CHECKED_DIR, CHECKED_SO_PATH, CHECKED_LOG_PATH) if checked
            else (BUILD_DIR, SO_PATH, LOG_PATH))


def build_command(nvcc: str, src: str, obj: str,
                  checked: bool = False) -> list:
    """The nvcc command that compiles one source (`-Xptxas -v`: the
    resource report goes to the build log)."""
    return ([nvcc] + NVCC_FLAGS + (CHECKED_FLAGS if checked else [])
            + ['-Xptxas', '-v', '-c', src, '-o', obj])


def _fresh(checked: bool = False) -> bool:
    so = _paths(checked)[1]
    if not os.path.exists(so):
        return False
    m = os.path.getmtime(so)
    return all(os.path.getmtime(s) <= m for s in SOURCES + HEADERS)


def build(checked: bool = False) -> str:
    """Compile every source in parallel (one nvcc each, `-Xptxas -v`
    resource report kept in the directory's kernels_build.log), link, and
    move the library into place: the product library, or with `checked`
    the checked one (CHECKED_FLAGS added) in its own directory."""
    t0 = time.monotonic()
    nvcc = nvcc_path()
    out_dir, so_path, log_path = _paths(checked)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(
                tmp, os.path.splitext(os.path.basename(src))[0] + '.o')
            objs.append(obj)
            procs.append(subprocess.Popen(
                build_command(nvcc, src, obj, checked),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        with open(log_path, 'w') as f:
            f.write('\n'.join(logs))
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src}:\n{log}')
        out = os.path.join(tmp, os.path.basename(so_path))
        subprocess.run([nvcc] + NVCC_FLAGS[:2] + ['-shared', '-o', out]
                       + objs, check=True)
        os.replace(out, so_path)
    with open(log_path, 'a') as f:
        f.write(f'\n# build seconds: {time.monotonic() - t0:.3f}\n')
    return so_path


def ensure_built(checked: bool = False) -> str:
    out_dir, so_path, _ = _paths(checked)
    if _fresh(checked):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'kernels.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh(checked):
            build(checked)
    return so_path


def _declare(so) -> None:
    """The C interface's argument and result types."""
    P, I = ctypes.c_void_p, ctypes.c_int
    so.jt_dequant_idct.argtypes = [P, P, P, P, P, P, I, I, P]
    so.jt_dequant_idct.restype = I
    so.jt_dequant_idct_compact.argtypes = [P] * 7 + [I, ctypes.c_longlong, P]
    so.jt_dequant_idct_compact.restype = I
    so.jt_mc_combine.argtypes = [P] * 13 + [I, I, I, I, P]
    so.jt_mc_combine.restype = I
    so.jt_mc_combine_grid.argtypes = [I]
    so.jt_mc_combine_grid.restype = I
    so.jt_mc_combine_flag_words.argtypes = [I, I]
    so.jt_mc_combine_flag_words.restype = ctypes.c_longlong
    so.jt_mc_combine_band.argtypes = [P] * 18 + [I] * 7 + [P]
    so.jt_mc_combine_band.restype = I
    so.jt_wire_unpack_launches.argtypes = []
    so.jt_wire_unpack_launches.restype = I
    so.jt_wire_unpack.argtypes = ([P, ctypes.c_longlong] + [I] * 8
                                  + [P, ctypes.c_longlong] + [P] * 9)
    so.jt_wire_unpack.restype = I


def lib():
    """The loaded kernel library: the product one, built on first use,
    or the checked one once bind_checked() bound it."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(ensure_built())
        _declare(so)
        _lib = so
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> int:
    """Validate one kernel argument; returns its data pointer."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must have shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    return t.data_ptr()


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{kernel} kernel launch failed: CUDA error {rc}')


# ------------------------------------------------------------ checked build

# csrc/checked.cuh's jt::Kind, in order, and what the rig counts each as
KINDS = ('none', 'bounds_global', 'bounds_shared', 'raw', 'war', 'waw',
         'flag_read', 'flag_publish', 'flag_prefix', 'spin', 'checker')
CATEGORY = {'bounds_global': 'faults', 'bounds_shared': 'faults',
            'checker': 'faults', 'raw': 'hazards', 'war': 'hazards',
            'waw': 'hazards', 'flag_read': 'flag_faults',
            'flag_publish': 'flag_faults', 'flag_prefix': 'flag_faults',
            'spin': 'flag_faults'}
# jt::Fault, one record per source (K1's, K2's, K3's)
FAULT_DTYPE = np.dtype({
    'names': ['count', 'claimed', 'kind', 'site', 'block', 'thread',
              'other', 'index', 'extent'],
    'formats': [(np.uint32, len(KINDS)), np.uint32, np.int32, np.int32,
                np.int32, np.int32, np.int32, np.int64, np.int64],
    'offsets': [0, 44, 48, 52, 56, 60, 64, 72, 80], 'itemsize': 88})
# each source's JT_FILE (its site ids' high half) and its kernel
SITE_FILES = {1: 'dequant_idct.cu', 2: 'mc_combine.cu', 3: 'wire_unpack.cu'}
FILE_KERNEL = {1: 'dequant_idct', 2: 'mc_combine', 3: 'wire_unpack'}
# the JT_ macros that stand at no site (parameters, a constant, exports);
# every other JT_ call in the sources is one: an access, barrier, protocol
# check, delay or negative control
_NOT_SITES = {'JT_ARG', 'JT_PASS', 'JT_SPIN_SCALE', 'JT_CHECKED_EXPORTS'}
# device bytes of the checker's buffer (the shadow of shared memory, K2's
# waited rows): enough for a slot per CTA of every launch the rig makes
# but the largest K3 write passes, whose CTAs then share slots
CHECKED_SHADOW_BYTES = 1 << 29


class Injection(NamedTuple):
    """A negative control: the kernel it is planted in, what it does, the
    kinds a report of it may have and the functions of its report's site
    ('unwritten': found by the rig's two poisons, not by the device)."""
    kernel: str
    what: str
    kinds: tuple
    functions: tuple


INJECTIONS = {
    1: Injection('dequant_idct', "K1 reads one element past its block's "
                 'levels', ('bounds_global',), ('dequant_idct_kernel',)),
    2: Injection('mc_combine', "K2 skips one row's wait", ('flag_read',),
                 ('frame_loop_kernel', 'stage_issue')),
    3: Injection('mc_combine', 'K2 stages one window row past the plane '
                 'clamp', ('bounds_global',), ('stage_issue',)),
    4: Injection('mc_combine', 'K2 publishes one row before its stores',
                 ('flag_publish',), ('publish',)),
    5: Injection('wire_unpack', "K3's write pass skips one barrier",
                 ('raw', 'war', 'waw'), ('scatter_mb', 'write_kernel')),
    6: Injection('wire_unpack', 'K3 skips one lattice store',
                 ('unwritten',), ('write_kernel',)),
    7: Injection('dequant_idct', "K1's compact form skips one block's "
                 'store', ('unwritten',), ('dequant_idct_compact_kernel',)),
}


class Site(NamedTuple):
    file: str
    line: int
    macro: str
    function: str


_FUNC_RE = re.compile(r'(\w+)\s*\(')


def _function_at(lines: list, i: int) -> str:
    """The function whose body holds line i: the nearest line above that
    starts a definition at column 0 (its last name before a '(' other
    than __launch_bounds__)."""
    for j in range(i, -1, -1):
        ln = lines[j]
        if not ln[:1].strip() or ln[0] in '#/}{' or ln.startswith(
                ('namespace', 'struct', 'constexpr', 'template')):
            continue
        names = [n for n in _FUNC_RE.findall(ln)
                 if n not in ('__launch_bounds__', '__align__')]
        if names:
            return names[-1]
    return '?'


def site_table(sources=SOURCES) -> dict:
    """The checked build's sites, parsed from the sources: {site id
    (JT_FILE << 16 | line): Site}, for every line of a JT_ macro's call
    (a call spanning lines is listed under each of its lines, so the
    device's __LINE__ finds it whichever line the preprocessor gives)."""
    table = {}
    for path in sources:
        with open(path) as f:
            lines = f.read().split('\n')
        fid = next(int(m[1]) for m in map(
            re.compile(r'#define JT_FILE (\d+)').match, lines) if m)
        for i, ln in enumerate(lines):
            if ln.lstrip().startswith(('#', '//')):
                continue
            for m in re.finditer(r'\b(JT_[A-Z0-9_]+)\(', ln):
                if m[1] in _NOT_SITES:
                    continue
                depth, j, k = 0, i, m.end() - 1
                while True:          # the call's closing parenthesis
                    for ch in lines[j][k:]:
                        depth += {'(': 1, ')': -1}.get(ch, 0)
                        if depth == 0:
                            break
                    if depth == 0:
                        break
                    j, k = j + 1, 0
                site = Site(os.path.basename(path), i + 1, m[1],
                            _function_at(lines, i))
                for line in range(i + 1, j + 2):
                    table.setdefault((fid << 16) | line, site)
    return table


class CheckedFault(RuntimeError):
    """A checked launch reported: `reports` holds each source's record
    that did (kernel, kind, site, counts by kind)."""

    def __init__(self, message: str, reports: list):
        super().__init__(message)
        self.reports = reports


def decode_fault(record, file_id: int, sites: dict) -> dict:
    """One source's fault record (a FAULT_DTYPE element) as a dict:
    kernel, kind, site (Site or None), where ('file:line'), index,
    extent, block, thread, other, counts {kind: n}, and a message."""
    counts = {KINDS[k]: int(n) for k, n in enumerate(record['count'])
              if n and k}
    kind = KINDS[int(record['kind'])] if 0 <= record['kind'] < len(
        KINDS) else f'kind {int(record["kind"])}'
    site = sites.get(int(record['site']))
    where = (f'{site.file}:{site.line}' if site else
             f'{SITE_FILES.get(int(record["site"]) >> 16, "?")}:'
             f'{int(record["site"]) & 0xFFFF}')
    rec = {'kernel': FILE_KERNEL.get(file_id, '?'), 'kind': kind,
           'site': site, 'where': where,
           'function': site.function if site else '?',
           'index': int(record['index']), 'extent': int(record['extent']),
           'block': int(record['block']), 'thread': int(record['thread']),
           'other': int(record['other']), 'counts': counts}
    rec['message'] = (
        f'{rec["kernel"]}: {kind} at {where} ({rec["function"]}'
        f'{", " + site.macro if site else ""}): index {rec["index"]}, '
        f'extent {rec["extent"]}, block {rec["block"]}, thread '
        f'{rec["thread"]}' + (f', other thread {rec["other"]}'
                              if rec['other'] >= 0 else '')
        + f'; counts {counts}')
    return rec


class Checked:
    """The checked library bound in this process (bind_checked): the
    settings of the launches to come (`poison`: a byte every output and
    scratch buffer is filled with first, or None; `seed`: the
    perturbation seed, 0 none; `inject`: a negative control, 0 none), the
    checked launches by kernel and form, and the faults raised by kind
    (`faults`; those of launches with a negative control planted in
    `injected`)."""

    def __init__(self, so, shadow: torch.Tensor):
        self.lib = so
        self.shadow = shadow          # kept alive: the library holds it
        self.sites = site_table()
        self.poison = None
        self.seed = 0
        self.inject = 0
        self.launches = dict.fromkeys(CHECKED_FORMS, 0)
        self.faults = dict.fromkeys(KINDS[1:], 0)
        self.injected = dict.fromkeys(KINDS[1:], 0)
        self.words = so.jt_checked_fault_words()
        if self.words * 4 != FAULT_DTYPE.itemsize:
            raise RuntimeError(f'the checked library\'s fault record is '
                               f'{self.words} words, FAULT_DTYPE '
                               f'{FAULT_DTYPE.itemsize} bytes')

    def fill(self, *tensors) -> None:
        """Poison the buffers a launch is about to write."""
        if self.poison is not None:
            for t in tensors:
                t.view(torch.uint8).fill_(self.poison)

    def before(self) -> None:
        _raise_on(self.lib.jt_checked_reset(), 'jt_checked_reset')
        self.lib.jt_checked_seed(self.seed)
        self.lib.jt_checked_inject(self.inject)

    def records(self) -> list:
        """The three sources' records, decoded, that hold a fault."""
        raw = np.zeros(3 * self.words, np.int32)
        _raise_on(self.lib.jt_checked_fault(raw.ctypes.data),
                  'jt_checked_fault')
        recs = raw.view(FAULT_DTYPE)
        return [decode_fault(recs[i], i + 1, self.sites) for i in range(3)
                if recs[i]['claimed']]

    def after(self, form: str) -> None:
        """A checked launch of `form` (CHECKED_FORMS) was queued: wait for
        it, count it, and raise CheckedFault on any fault."""
        torch.cuda.synchronize()
        self.launches[form] += 1
        reports = self.records()
        tally = self.injected if self.inject else self.faults
        for r in reports:
            for kind, n in r['counts'].items():
                tally[kind] += n
        if reports:
            raise CheckedFault('; '.join(r['message'] for r in reports),
                               reports)


# checked launches are counted by kernel and form
CHECKED_FORMS = ('dequant_idct.compact', 'dequant_idct.levels',
                 'dequant_idct.premultiplied', 'mc_combine.one_stream',
                 'mc_combine.segmented', 'mc_combine.band', 'wire_unpack')

_checked = None     # the Checked of this process (bind_checked), or None


def _shadow_buffer(n_bytes: int) -> torch.Tensor:
    """The checker's device buffer."""
    return torch.empty(n_bytes, dtype=torch.uint8, device='cuda')


def bind_checked() -> Checked:
    """Build (if stale) and load the checked library as this process's
    kernel library, with the checker's device buffer.  Raises if there
    is no CUDA device or the product library is already loaded here; a
    second call returns the first's Checked."""
    global _lib, _checked
    if _checked is not None:
        return _checked
    if _lib is not None:
        raise RuntimeError('bind_checked: the product kernel library is '
                           'already loaded in this process; bind the '
                           'checked one first, in a process of its own')
    if not torch.cuda.is_available():
        raise RuntimeError('bind_checked: no CUDA device is available')
    so = ctypes.CDLL(ensure_built(checked=True))
    _declare(so)
    P = ctypes.c_void_p
    for name in ('jt_checked_fault', 'jt_checked_reset'):
        getattr(so, name).restype = ctypes.c_int
    so.jt_checked_fault.argtypes = [P]
    so.jt_checked_reset.argtypes = []
    so.jt_checked_fault_words.argtypes = []
    so.jt_checked_fault_words.restype = ctypes.c_int
    so.jt_checked_shadow.argtypes = [P, ctypes.c_longlong]
    so.jt_checked_shadow.restype = None
    so.jt_checked_seed.argtypes = [ctypes.c_ulonglong]
    so.jt_checked_seed.restype = None
    so.jt_checked_inject.argtypes = [ctypes.c_int]
    so.jt_checked_inject.restype = None
    shadow = _shadow_buffer(CHECKED_SHADOW_BYTES)
    so.jt_checked_shadow(shadow.data_ptr(), shadow.numel())
    _checked = Checked(so, shadow)
    _lib = so
    return _checked


def k2_form(n_seg: int, seg, band) -> str:
    """The K2 instantiation a launch runs (jt_mc_combine's rule: segments
    or frame counts on the device take the segmented one)."""
    if band is not None:
        return 'mc_combine.band'
    return ('mc_combine.segmented' if n_seg > 1 or seg is not None
            else 'mc_combine.one_stream')


def dequant_idct_cuda(x, qscale=None, intra=None, intra_q=None,
                      non_intra_q=None,
                      premultiplied: bool = False) -> torch.Tensor:
    """K1 (csrc/dequant_idct.cu) on int16 levels, or on int32
    premultiplied coefficients when `premultiplied`; see
    ops.idct.dequant_idct for the contract."""
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'dequant_idct_cuda needs a CUDA tensor, got {dev}')
    if x.dim() != 3:
        raise ValueError(f'expected [n_mb, 6, 64], got {tuple(x.shape)}')
    n_mb = x.shape[0]
    if premultiplied:
        xp = _check(x, 'coef', torch.int32, (n_mb, 6, 64), dev)
        qp = ip = iqp = nqp = None
    else:
        xp = _check(x, 'levels', torch.int16, (n_mb, 6, 64), dev)
        qp = _check(qscale, 'qscale', torch.uint8, (n_mb,), dev)
        ip = _check(intra, 'intra', torch.bool, (n_mb,), dev)
        iqp = _check(intra_q, 'intra_q', torch.int32, (64,), dev)
        nqp = _check(non_intra_q, 'non_intra_q', torch.int32, (64,), dev)
    out = torch.empty((n_mb, 6, 64), dtype=torch.int32, device=dev)
    if n_mb == 0:
        return out
    chk = _checked
    if chk is not None:
        chk.fill(out)
        chk.before()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().jt_dequant_idct(xp, qp, ip, iqp, nqp, out.data_ptr(),
                                   n_mb * 6, int(premultiplied), stream)
    _raise_on(rc, 'dequant_idct')
    form = ('dequant_idct.premultiplied' if premultiplied
            else 'dequant_idct.levels')
    launches['dequant_idct'] += 1
    k1_forms[form] += 1
    if chk is not None:
        chk.after(form)
    return out


def dequant_idct_compact_cuda(levels, blk_ids, qscale, intra, intra_q,
                              non_intra_q, n_blocks: int) -> torch.Tensor:
    """K1's compact form (csrc/dequant_idct.cu): row i of the int16
    levels [n, 64] is block blk_ids[i] (int32 [n], -1: none) of the int32
    [n_blocks, 64] residuals returned, its macroblock blk_ids[i] // 6 of
    qscale uint8 and intra bool [n_blocks // 6]; see
    ops.idct.dequant_idct_compact for the contract.  The output is
    `torch.empty`: the kernel writes the named blocks only."""
    dev = levels.device
    if dev.type != 'cuda':
        raise ValueError(f'dequant_idct_compact_cuda needs a CUDA tensor, '
                         f'got {dev}')
    if levels.dim() != 2 or n_blocks % 6 or n_blocks < 0:
        raise ValueError(f'expected levels [n, 64] and n_blocks a multiple '
                         f'of 6, got {tuple(levels.shape)}, {n_blocks}')
    n = levels.shape[0]
    if n >= 2**31:
        raise ValueError(f'{n} rows are over the kernel\'s int32 count')
    lp = _check(levels, 'levels', torch.int16, (n, 64), dev)
    bp = _check(blk_ids, 'blk_ids', torch.int32, (n,), dev)
    qp = _check(qscale, 'qscale', torch.uint8, (n_blocks // 6,), dev)
    ip = _check(intra, 'intra', torch.bool, (n_blocks // 6,), dev)
    iqp = _check(intra_q, 'intra_q', torch.int32, (64,), dev)
    nqp = _check(non_intra_q, 'non_intra_q', torch.int32, (64,), dev)
    out = torch.empty((n_blocks, 64), dtype=torch.int32, device=dev)
    # the kernel moves levels and residuals 16 bytes at a time
    if lp % 16 or out.data_ptr() % 16:
        raise ValueError('dequant_idct_compact_cuda needs 16-byte aligned '
                         'levels')
    if n == 0:
        return out
    chk = _checked
    if chk is not None:
        chk.fill(out)
        chk.before()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().jt_dequant_idct_compact(lp, bp, qp, ip, iqp, nqp,
                                           out.data_ptr(), n, n_blocks,
                                           stream)
    _raise_on(rc, 'dequant_idct')
    launches['dequant_idct'] += 1
    k1_forms['dequant_idct.compact'] += 1
    if chk is not None:
        chk.after('dequant_idct.compact')
    return out


def check_segments(mb_h: int, n_frames: int, n_seg: int,
                   seg_frames=None) -> list:
    """The frame count of each of `n_seg` segments stacked along the
    macroblock rows of a batch of `n_frames` frames: `seg_frames` (ints,
    each in [0, n_frames]) or, when None, n_frames for every segment.
    Raises ValueError when the rows do not split evenly or a count is
    out of range."""
    if n_seg < 1 or mb_h % n_seg:
        raise ValueError(f'{mb_h} macroblock rows do not split into '
                         f'{n_seg} segments')
    if seg_frames is None:
        return [n_frames] * n_seg
    counts = [int(c) for c in seg_frames]
    if len(counts) != n_seg or not all(0 <= c <= n_frames for c in counts):
        raise ValueError(f'seg_frames {counts} must hold {n_seg} counts in '
                         f'[0, {n_frames}]')
    return counts


class Band(NamedTuple):
    """K2's band mode: a launch decodes ONE frame of the macroblock rows
    [row0, row0 + mb_h_local) of a picture of mb_h real rows, for each of
    its n_seg segments (the launch's planes hold the segments' bands
    stacked).  top / bot: (y, cr, cb) uint8 halo rows above and below each
    segment's band, [n_seg * 16 * halo_mb, W] (chroma half).  frame: this
    frame's index, compared with seg_frames (each segment's frame
    count)."""
    top: tuple
    bot: tuple
    row0: int
    mb_h: int
    halo_mb: int
    frame: int


# a band launch's counts are its segments' GOP lengths (int32 on the card),
# compared with Band.frame: no frame count bounds them
BAND_COUNT_MAX = 2**31 - 1


def mc_combine_cuda(cur, fwd, resid: torch.Tensor, meta: torch.Tensor,
                    n_seg: int = 1, seg_frames=None, band: Band = None):
    """K2 (csrc/mc_combine.cu): the frame loop of one batch in one
    cooperative launch, each macroblock waiting on per-row readiness
    flags for the rows of earlier frames that it reads.  cur/fwd: the
    carried (y, cr, cb) uint8 planes; resid int32 [F, n_mb, 6, 64]; meta
    int32 [F, n_mb, 3].  With n_seg > 1 the planes are n_seg streams
    stacked along macroblock rows: motion clamps rows at each segment's
    edges, and segment s decodes its first seg_frames[s] frames only (see
    ops.frame.decode_frames_ref).  Returns the F new pictures as
    (y [F, H, W], cr, cb [F, H/2, W/2]).  Shapes and segments are checked
    before the device, so a mismatch raises on any device.  With `band`
    the launch runs K2's band mode (`Band`): F = 1, the planes are the
    segments' bands, segment s decodes when band.frame < seg_frames[s]."""
    dev = cur[0].device
    H, W = cur[0].shape
    if H % 16 or W % 16:
        raise ValueError(f'plane {H}x{W} is not macroblock-aligned')
    # the kernel's in-plane offsets are int
    if H * W >= 2**31:
        raise ValueError(f'plane {H}x{W} is over 2^31 bytes')
    if resid.dim() != 4:
        raise ValueError(f'resid must be [F, n_mb, 6, 64], got '
                         f'{tuple(resid.shape)}')
    F = resid.shape[0]
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    named = [('cur', cur, shapes), ('fwd', fwd, shapes)]
    if band is None:
        counts = check_segments(mb_h, F, n_seg, seg_frames)
        idle = all(c == F for c in counts)
    else:
        if F != 1:
            raise ValueError(f'a band launch is one frame: resid must be '
                             f'[1, n_mb, 6, 64], got {tuple(resid.shape)}')
        counts = check_segments(mb_h, BAND_COUNT_MAX, n_seg, seg_frames)
        if not 0 <= band.halo_mb <= mb_h // n_seg:
            raise ValueError(f'{mb_h} band rows in {n_seg} segments with a '
                             f'halo of {band.halo_mb} rows')
        if band.row0 < 0 or band.mb_h < 1:
            raise ValueError(f'band at row {band.row0} of {band.mb_h}')
        hy = n_seg * band.halo_mb * 16
        halos = ((hy, W), (hy // 2, W // 2), (hy // 2, W // 2))
        named += [('top', band.top, halos), ('bot', band.bot, halos)]
        idle = all(band.frame < c for c in counts)
    planes = []
    for name, ps, shp in named:
        for pn, p, shape in zip(('y', 'cr', 'cb'), ps, shp):
            planes.append(_check(p, f'{name}.{pn}', torch.uint8, shape, dev))
    rp = _check(resid, 'resid', torch.int32, (F, n_mb, 6, 64), dev)
    mp = _check(meta, 'meta', torch.int32, (F, n_mb, 3), dev)
    if dev.type != 'cuda':
        raise ValueError(f'mc_combine_cuda needs CUDA tensors, got {dev}')
    # the kernel reads plane rows and residuals 16 bytes at a time
    if any(q % 16 for q in planes) or rp % 16:
        raise ValueError('mc_combine_cuda needs 16-byte aligned planes and '
                         'residuals')
    out = tuple(torch.empty((F,) + s, dtype=torch.uint8, device=dev)
                for s in shapes)
    if F == 0:
        return out
    # no counts on the device when every segment decodes every frame of
    # the launch: the kernel then skips the test
    seg = (None if idle else
           torch.tensor(counts, dtype=torch.int32).pin_memory().to(
               dev, non_blocking=True))
    seg_ptr = None if seg is None else seg.data_ptr()
    outs = [o.data_ptr() for o in out]
    chk = _checked
    if chk is not None:
        chk.fill(*out)
        chk.before()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if band is None:
            # the readiness flags: stored macroblocks per (frame, row)
            done = torch.zeros(lib().jt_mc_combine_flag_words(F, mb_h),
                               dtype=torch.int32, device=dev)
            rc = lib().jt_mc_combine(*planes, rp, mp, *outs,
                                     done.data_ptr(), seg_ptr, F, mb_h,
                                     mb_w, n_seg, stream)
        else:
            rc = lib().jt_mc_combine_band(
                *planes, rp, mp, *outs, seg_ptr, mb_h // n_seg, mb_w, n_seg,
                band.row0, band.mb_h, band.halo_mb, band.frame, stream)
    _raise_on(rc, 'mc_combine')
    launches['mc_combine'] += 1
    if chk is not None:
        chk.after(k2_form(n_seg, seg, band))
    return out


def wire_unpack_scratch_bytes(n_streams: int, n_frames: int, n_mb: int,
                              n_pairs: int, n_blk: int) -> int:
    """The scratch of one K3 call: csrc/wire_unpack.cu's scratch_rule (8
    bytes a macroblock, pair and ordinal of each stream, 16 KB a stream and
    1 KB), which covers the kernel's layout; the kernel carves it and
    refuses a smaller one."""
    return 8 * n_streams * (n_frames * n_mb + n_pairs + n_blk + 2048) + 1024


def wire_unpack_cuda(bufs: torch.Tensor, n_frames: int, n_mb: int,
                     n_runs: int, mv_wide: bool, n_pairs: int, n_esc: int,
                     n_blk: int) -> tuple:
    """K3 (csrc/wire_unpack.cu): S packed wires v2 at shared sizes,
    uint8 [S, L], unpacked into the compact levels of the S streams' coded
    blocks (stream s's at rows [s*n_blk, (s+1)*n_blk)) and the fields of
    their macroblocks joined, stream s in columns [s*n_mb, (s+1)*n_mb).
    Returns the LevelsArrays fields in order: levels int16 [S*n_blk, 64],
    qscale uint8 [F, S*n_mb], coded bool [F, S*n_mb, 6], intra, written
    bool, mv_h, mv_v int32, blk_ids int32 [S*n_blk]; see
    models.mpeg1.unpack_wires for the contract.
    One ctypes call queues a memset of the scan's status words and the
    two launches.  Sizes and shapes are checked before the device, so a
    mismatch raises on any device."""
    # the wire layout and the lattice limit are models.mpeg1's (which
    # imports this module)
    from ..models.mpeg1 import LATTICE_LIMIT, fused_buffer_len
    dev = bufs.device
    if bufs.dim() != 2:
        raise ValueError(f'expected wires [S, L], got {tuple(bufs.shape)}')
    S = bufs.shape[0]
    sizes = (n_frames, n_mb, n_runs, n_pairs, n_esc, n_blk)
    if S < 1 or S > 65535 or min(sizes) < 1:
        raise ValueError(f'wire_unpack_cuda needs 1 <= S <= 65535 and '
                         f'every size >= 1, got S={S}, sizes {sizes}')
    # the kernel counts levels, pairs, escapes and runs in int32 (a pair
    # index runs up to a tile past n_pairs)
    if n_frames * S * n_mb * 6 * 64 > LATTICE_LIMIT or \
            max(n_pairs, n_esc, n_runs) > 2**30:
        raise ValueError(f'wire_unpack_cuda: {S} wires of {n_frames} x '
                         f'{n_mb} macroblocks, {n_pairs} pairs are over '
                         f'its int32 counts')
    L = fused_buffer_len(n_frames, n_mb, n_pairs, n_runs, mv_wide, n_esc)
    bp = _check(bufs, 'bufs', torch.uint8, (S, L), dev)
    if dev.type != 'cuda':
        raise ValueError(f'wire_unpack_cuda needs a CUDA tensor, got {dev}')
    F, M = n_frames, S * n_mb
    out = (torch.empty((S * n_blk, 64), dtype=torch.int16, device=dev),
           torch.empty((F, M), dtype=torch.uint8, device=dev),
           torch.empty((F, M, 6), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.int32, device=dev),
           torch.empty((F, M), dtype=torch.int32, device=dev),
           torch.empty((S * n_blk,), dtype=torch.int32, device=dev))
    n_scratch = wire_unpack_scratch_bytes(S, F, n_mb, n_pairs, n_blk)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    chk = _checked
    if chk is not None:
        chk.fill(*out, scratch)
        chk.before()
    # launch on the tensors' device, entered only when it is not current
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        rc = lib().jt_wire_unpack(
            bp, L, S, F, n_mb, n_runs, int(mv_wide), n_pairs, n_esc, n_blk,
            scratch.data_ptr(), n_scratch, out[0].data_ptr(),
            out[7].data_ptr(), *[o.data_ptr() for o in out[1:7]],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, 'wire_unpack')
    launches['wire_unpack'] += 1
    if chk is not None:
        chk.after('wire_unpack')
    return out


if __name__ == '__main__':
    print(ensure_built())

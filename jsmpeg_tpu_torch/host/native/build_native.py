"""Build the C++ host frontend: generates vlc_tables.h from the canonical
Python tables, compiles frontend.cpp to libjsmpeg_host.so.

Both land in `build/jsmpeg_tpu_torch/` at the checkout root, never next
to the sources.  A file lock serialises concurrent builds (test
workers), and the library is renamed into place only once complete.

  python -m jsmpeg_tpu_torch.host.native.build_native
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    HERE))), 'build', 'jsmpeg_tpu_torch')
SO_PATH = os.path.join(BUILD_DIR, 'libjsmpeg_host.so')
SRCS = [os.path.join(HERE, 'frontend.cpp'), os.path.join(HERE, 'mp2.cpp'),
        os.path.join(HERE, 'ts_demux.cpp')]
DEPS = SRCS + [os.path.join(HERE, 'bitview.h'),
               os.path.join(HERE, 'gen_tables.py'),
               os.path.join(os.path.dirname(os.path.dirname(HERE)),
                            'tables.py')]


def _fresh(path: str, deps) -> bool:
    """True when `path` exists and no dependency is newer."""
    if not os.path.exists(path):
        return False
    m = os.path.getmtime(path)
    return all(os.path.getmtime(f) <= m for f in deps)


def build(verbose: bool = True) -> str:
    from .gen_tables import generate
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        generate(os.path.join(tmp, 'vlc_tables.h'))
        out = os.path.join(tmp, 'libjsmpeg_host.so')
        cmd = ['g++', '-O3', '-march=native', '-std=c++17', '-shared',
               '-fPIC', '-I', tmp, '-I', HERE, '-o', out] + SRCS
        if verbose:
            print('+', ' '.join(cmd))
        subprocess.run(cmd, check=True, cwd=HERE)
        os.replace(out, SO_PATH)
    return SO_PATH


def ensure_built() -> str:
    """Build if missing or stale (a source newer than the .so)."""
    if _fresh(SO_PATH, DEPS):
        return SO_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'host.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh(SO_PATH, DEPS):
            build(verbose=False)
    return SO_PATH


if __name__ == '__main__':
    print(build())

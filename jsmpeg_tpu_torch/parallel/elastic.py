"""Elastic GOP-shard decode: a worker's failure re-dispatches its shard
(the port of jsmpeg_tpu/parallel/elastic.py).

A process group cannot lose a member mid-job (a dead rank stalls every
collective), so recovery lives one level above it: a coordinator hands
closed-GOP byte ranges to worker processes over localhost sockets and
re-queues the in-flight range of any worker that dies (SIGKILL, crash,
socket loss) or wedges (its reply times out).  Results are idempotent
files keyed by GOP index, so a re-run of the same shard is harmless.

  coordinator: decode_gops_elastic(es, n_workers=3, device='cuda')
  worker:      python -m jsmpeg_tpu_torch.parallel.elastic HOST PORT \\
                   ES_PATH OUTDIR --device D

Each worker decodes its ranges with the port's MPEG1Decoder on the
coordinator's device (the card unless it is given the CPU; a worker told
'cuda' on a machine without a card exits non-zero) and sends its own pid
in its ready handshake: the coordinator names each connection's worker
by that pid, not by the order the connections arrive in.  Each range is
primed with the shared sequence-header prefix, as in the multi-process
path (multihost.parse_gop_range).  Test hooks: JSMPEG_ELASTIC_DIE_AFTER=n
(the worker exits as its (n+1)-th job arrives) and
JSMPEG_ELASTIC_HANG_AFTER=n (it stops replying instead).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from .multihost import index_gops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _send(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + '\n').encode())


class _LineReader:
    def __init__(self, sock: socket.socket):
        self._f = sock.makefile('r')

    def recv(self) -> Optional[dict]:
        line = self._f.readline()
        if not line:
            return None
        return json.loads(line)


def _build_first(device) -> None:
    """Build the host parser (and, for the card, the kernels) in this
    process before the workers start, so that they load the libraries
    and do not all build them at once."""
    from ..host.native.build_native import ensure_built
    ensure_built()
    if device.type == 'cuda':
        from ..ops import kernels
        kernels.ensure_built()


def decode_gops_elastic(es: bytes, n_workers: int = 3,
                        outdir: Optional[str] = None,
                        worker_env: Optional[dict] = None,
                        on_assign=None, timeout: float = 300.0,
                        device=None, stats: Optional[dict] = None):
    """Decode an elementary stream by sharding its closed GOPs over
    `n_workers` worker processes on `device` (default the card; raises
    without one), with failure recovery: a worker that dies or stops
    replying mid-shard has its shard re-queued to the survivors.

    Returns (n_frames_per_gop, frames): frames is the full ordered list
    of decoded (y, cr, cb) numpy tuples, bit-exact to a serial decode.
    `on_assign(worker_id, pid, gop_index)` is a test hook fired before
    each job is sent (worker_id counts connections; pid is the one the
    worker reported).  `stats`, when given, receives 'done_by' {gop: pid
    of the worker that reported it done} and 'launches' {pid: that
    worker's kernel launches}.  Raises RuntimeError when every worker
    died with shards outstanding."""
    from ..config import resolve_device
    device = resolve_device(device, 'decode_gops_elastic')
    header, ranges = index_gops(es)
    if not ranges:
        return [], []
    _build_first(device)
    own_tmp = outdir is None
    tmp = tempfile.mkdtemp(prefix='jsmpeg_elastic_') if own_tmp else outdir
    es_path = os.path.join(tmp, 'stream.es')
    with open(es_path, 'wb') as f:
        f.write(es)
    stats = {} if stats is None else stats
    stats.update(done_by={}, launches={})

    srv = socket.socket()
    srv.bind(('127.0.0.1', 0))
    srv.listen(n_workers)
    port = srv.getsockname()[1]
    env = dict(os.environ)
    if worker_env:
        env.update(worker_env)
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'jsmpeg_tpu_torch.parallel.elastic',
         '127.0.0.1', str(port), es_path, tmp, '--device', str(device)],
        env=env, cwd=ROOT) for _ in range(n_workers)]

    jobs: List[Tuple[int, int, int, int]] = [
        (gi, s, e, n) for gi, (s, e, n) in enumerate(ranges)]
    pending = list(reversed(jobs))         # pop() serves in stream order
    done: set = set()
    lock = threading.Condition()
    alive = [0]                            # handlers still running

    def handle(worker_id: int, sock: socket.socket):
        reader = _LineReader(sock)
        try:
            try:
                hello = reader.recv()      # ready handshake, with the pid
            except OSError:
                hello = None
            if not hello or 'pid' not in hello:
                return
            pid = int(hello['pid'])
            while True:
                with lock:
                    while not pending and len(done) < len(jobs):
                        lock.wait(0.1)
                    if len(done) >= len(jobs):
                        return
                    job = pending.pop()
                if on_assign is not None:
                    on_assign(worker_id, pid, job[0])
                try:
                    _send(sock, {'gop': job[0], 'start': job[1],
                                 'end': job[2], 'n': job[3]})
                    r = reader.recv()
                except (OSError, ValueError):
                    r = None
                if r is None or r.get('done') != job[0]:
                    # the worker died mid-shard: re-queue for the survivors
                    with lock:
                        if job[0] not in done:
                            pending.append(job)
                        lock.notify_all()
                    return
                with lock:
                    done.add(job[0])
                    stats['done_by'][job[0]] = int(r.get('pid', -1))
                    stats['launches'][pid] = r.get('launches')
                    lock.notify_all()
        finally:
            with lock:
                alive[0] -= 1
                lock.notify_all()
            try:
                _send(sock, {'quit': True})
            except OSError:
                pass
            sock.close()

    threads = []
    try:
        # accept within a bounded window and go on with whoever showed
        # up: a worker that fails at start-up must not stall the decode
        # (the survivors absorb its shards); none at all is fatal
        deadline = time.monotonic() + min(60.0, timeout)
        for w in range(n_workers):
            with lock:
                if len(done) >= len(jobs):
                    break       # early workers already finished the job
            try:
                srv.settimeout(max(1.0, deadline - time.monotonic()))
                conn, _ = srv.accept()
            except (TimeoutError, OSError):
                break
            # a wedged worker (alive, never replying) must not hold its
            # shard forever: recv times out -> OSError -> re-queue
            conn.settimeout(timeout)
            with lock:
                alive[0] += 1
            t = threading.Thread(target=handle, args=(w, conn), daemon=True)
            t.start()
            threads.append(t)
        if not threads:
            raise RuntimeError('no elastic workers connected')
        with lock:
            while len(done) < len(jobs):
                if alive[0] == 0:
                    raise RuntimeError(
                        f'all workers died with {len(jobs) - len(done)} '
                        f'GOP shards outstanding')
                lock.wait(0.2)
        for t in threads:
            t.join(timeout=10)
    finally:
        srv.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    frames, counts = [], []
    for gi in range(len(ranges)):
        with np.load(os.path.join(tmp, f'gop_{gi}.npz')) as z:
            y, cr, cb = z['y'], z['cr'], z['cb']
        counts.append(len(y))
        frames.extend(zip(y, cr, cb))
    if own_tmp:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, frames


def _range_closed(header: bytes, chunk: bytes) -> bool:
    """True when this GOP byte range is an independent decode unit: its
    first two frames cover every macroblock (written or intra).  A
    slice-gap MB there would expose pre-GOP stale plane content
    (parallel/packed.gop_closed semantics), which a from-zero range
    decode cannot reproduce."""
    from ..host import best_parser
    p = best_parser()
    p.write(header + chunk)
    for _ in range(2):
        fd = p.parse_frame(eof=True)
        if fd is None:
            return True
        if not bool((np.asarray(fd.written) | np.asarray(fd.intra)).all()):
            return False
    return True


def _worker_main(host: str, port: int, es_path: str, outdir: str,
                 device: str) -> None:
    from ..models.mpeg1 import MPEG1Decoder
    from ..ops import kernels

    with open(es_path, 'rb') as f:
        es = f.read()
    header, _ = index_gops(es)
    MPEG1Decoder({'device': device})       # no card for 'cuda': raise now

    sock = socket.create_connection((host, port))
    reader = _LineReader(sock)
    _send(sock, {'ready': True, 'pid': os.getpid()})
    die_after = int(os.environ.get('JSMPEG_ELASTIC_DIE_AFTER', '-1'))
    hang_after = int(os.environ.get('JSMPEG_ELASTIC_HANG_AFTER', '-1'))
    jobs_done = 0
    while True:
        msg = reader.recv()
        if msg is None or msg.get('quit'):
            return
        gi, s, e = msg['gop'], msg['start'], msg['end']
        if die_after >= 0 and jobs_done >= die_after:
            os._exit(137)          # simulated SIGKILL mid-shard
        if hang_after >= 0 and jobs_done >= hang_after:
            while True:            # simulated wedge: alive, never replies
                time.sleep(60)
        dec = MPEG1Decoder({'device': device})
        if _range_closed(header, es[s:e]):
            dec.write(0.0, header + es[s:e])
            outs = list(dec.decode_available(eof=True) or [])
        else:
            # a slice-gap GOP depends on pre-GOP plane content: decode
            # the whole prefix (the reference's stale-pixel semantics)
            # and keep only this range's frames.  Slower, still idempotent
            dec.write(0.0, es[:e])
            allf = list(dec.decode_available(eof=True) or [])
            outs = allf[len(allf) - int(msg.get('n') or 0):]
        z = np.zeros((0, 0, 0), np.uint8)
        planes = [np.stack([o[i].cpu().numpy() for o in outs]) if outs
                  else z for i in range(3)]
        tmp_path = os.path.join(outdir, f'gop_{gi}.npz.tmp{os.getpid()}')
        with open(tmp_path, 'wb') as f:
            np.savez(f, y=planes[0], cr=planes[1], cb=planes[2])
        os.replace(tmp_path, os.path.join(outdir, f'gop_{gi}.npz'))
        jobs_done += 1
        _send(sock, {'done': gi, 'pid': os.getpid(),
                     'launches': dict(kernels.launches)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m jsmpeg_tpu_torch.parallel.elastic',
        description='An elastic decode worker: decodes the GOP ranges '
                    'its coordinator sends.')
    ap.add_argument('host')
    ap.add_argument('port', type=int)
    ap.add_argument('es_path')
    ap.add_argument('outdir')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    try:
        _worker_main(a.host, a.port, a.es_path, a.outdir, a.device)
    except RuntimeError as e:
        print(f'elastic worker: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Worker process for the port's multi-process decode test (spawned by
tests/test_torch_multihost.py, one per rank).  Joins a gloo process group,
decodes its GOP block of a deterministic stream on the CPU over four
device objects (the layout of tests/_mh_worker.py's four virtual devices),
writes its frames to an npz and prints one JSON line with its global
frame indices.  Exits 0 only when its frames equal a local serial decode.

    python tests/_torch_mh_worker.py PORT WORLD RANK N_TILE OUTDIR
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def stream(world: int) -> bytes:
    """tests/_mh_worker.py's stream: enough GOPs that every rank owns at
    least one real GOP row."""
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    n_frames = 14 if world <= 2 else 22
    return encode_realistic_stream(96, 128, n_frames=n_frames, seed=21,
                                   gop=3)[0]


def main():
    port, world, rank, n_tile = map(int, sys.argv[1:5])
    outdir = sys.argv[5]
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    from jsmpeg_tpu_torch.parallel import multihost as mh
    mh.initialize(f'tcp://127.0.0.1:{port}', world, rank)
    es = stream(world)
    _, frames, planes = mh.decode_packed_multihost(
        es, n_tile=n_tile, devices=['cpu', 'cpu:0'] * 2)
    assert frames, 'rank decoded nothing'
    dec = MPEG1Decoder({'device': 'cpu'})
    dec.write(0.0, es)
    ref = dec.decode_available(eof=True)
    for k, p in zip(frames, planes):
        for pn, a, b in zip(('y', 'cr', 'cb'), p, ref[k]):
            np.testing.assert_array_equal(a, b.numpy(),
                                          err_msg=f'frame {k} {pn}')
    np.savez(os.path.join(outdir, f'rank{rank}.npz'),
             frames=np.asarray(frames), y=np.stack([p.y for p in planes]),
             cr=np.stack([p.cr for p in planes]),
             cb=np.stack([p.cb for p in planes]))
    print(json.dumps({'rank': rank, 'frames': frames}), flush=True)


if __name__ == '__main__':
    main()

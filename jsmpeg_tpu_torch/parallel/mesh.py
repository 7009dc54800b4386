"""The decode mesh (the port of jsmpeg_tpu/parallel/mesh.py).

A `Mesh` is a [n_gop, n_tile] grid of cells, each holding a
`torch.device`.  Axes:
  'gop'  -- closed GOPs are independent decode units, spread over the
            gop rows;
  'tile' -- macroblock-row bands of one picture.

Like a JAX Mesh, it belongs to ONE process that drives every device in
it (single controller); several processes are the multi-host layer's
business, not this one's.  How the port runs it:
  - When the grid has more cells than devices, the cells take the
    devices in turn (row-major), so `make_mesh(8)` runs on one card, and
    on the CPU with `device='cpu'` (the counterpart of the CPU tests'
    eight virtual JAX devices).
  - Cells that share a device merge.  That device's GOPs decode as the
    segments of ONE K1 + ONE K2 launch pair: stacked along macroblock
    rows, `seg_frames` holding the GOP lengths (the counterpart of
    jsmpeg_tpu's `jax.vmap` over a shard's local GOPs).  Its tile cells
    cover the full picture height, so they need no halo and no band.
  - GOP rows on distinct devices each run their own launch pair on
    their own device.
  - Tile cells of one gop row on distinct devices place the picture's
    macroblock-row bands: band t on the row's cell t, decoded by
    parallel/tiles.decode_bands (K1 once per device, then per frame one
    K2 band launch per band and a halo exchange between neighbours).
    Rows with the same cells share that loop, their GOPs as segments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import resolve_device


class Mesh:
    """cells: n_gop rows of n_tile devices.  `shape` is
    {'gop': n_gop, 'tile': n_tile}."""

    def __init__(self, cells: Sequence[Sequence[torch.device]]):
        self.cells = [[torch.device(d) for d in row] for row in cells]
        self.shape = {'gop': len(self.cells), 'tile': len(self.cells[0])}

    def gop_devices(self) -> List[torch.device]:
        """The device of each gop row's first tile cell (where a banded
        row joins its frames)."""
        return [row[0] for row in self.cells]

    def row_bands(self) -> List[Tuple[torch.device, ...]]:
        """The bands of each gop row: (d,) when all its tile cells are
        device d (they merge and decode the whole picture), else its
        n_tile cells, band t on cell t."""
        return [tuple(row) if len(set(row)) > 1 else (row[0],)
                for row in self.cells]

    def gop_groups(self, n_units: int
                   ) -> Dict[Tuple[torch.device, ...], List[int]]:
        """Where units 0..n_units-1 (GOPs, in order) decode: jsmpeg_tpu
        pads them to ceil(n_units / n_gop) * n_gop slots and shards the
        slots over the gop rows, so unit i sits in row i // per_row (the
        pad slots are not launched here).  Returns the units of each row
        layout (`row_bands`) in order, the layouts in the order of their
        first unit: rows with the same cells merge."""
        rows = self.row_bands()
        per_row = max(1, -(-n_units // len(rows)))
        groups: Dict[Tuple[torch.device, ...], List[int]] = {}
        for i in range(n_units):
            groups.setdefault(rows[i // per_row], []).append(i)
        return groups


def make_mesh(n_gop: Optional[int] = None, n_tile: int = 1,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A [n_gop, n_tile] mesh over `devices`, by default every visible
    CUDA device (device None or 'cuda': raises without a GPU) or the one
    device named.  n_gop=None takes len(devices) // n_tile, as in JAX;
    the cells take the devices in turn."""
    if devices is None:
        dev = resolve_device(device, 'make_mesh')
        devices = ([torch.device('cuda', i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == 'cuda' and dev.index is None else [dev])
    devices = [torch.device(d) for d in devices]
    if n_gop is None:
        n_gop = len(devices) // n_tile
    if not devices or n_gop < 1 or n_tile < 1:
        raise ValueError(f'no {n_gop}x{n_tile} mesh over {len(devices)} '
                         'devices')
    return Mesh([[devices[(g * n_tile + t) % len(devices)]
                  for t in range(n_tile)] for g in range(n_gop)])


def resolve_mesh(spec, device=None) -> Optional[Mesh]:
    """Accepts what PlayerConfig.mesh / CLI --mesh carry and returns a
    Mesh (or None):
      Mesh          -> itself
      int n         -> n-way GOP parallel
      (g, t)        -> explicit shape
      '4x2' / '8'   -> parsed shape (gop x tile)
      'auto'/'all'  -> every visible device, GOP-parallel
    `device` as for make_mesh."""
    if spec is None:
        return None
    if isinstance(spec, Mesh):
        return spec
    kw = dict(device=device)
    if isinstance(spec, int):
        return make_mesh(n_gop=spec, n_tile=1, **kw)
    if isinstance(spec, (tuple, list)):
        g, t = spec
        return make_mesh(n_gop=int(g), n_tile=int(t), **kw)
    if isinstance(spec, str):
        s = spec.lower().replace('gop', '').replace('tile', '').strip()
        if s in ('auto', 'all'):
            return make_mesh(**kw)
        if 'x' in s:
            g, _, t = s.partition('x')
            return make_mesh(n_gop=int(g), n_tile=int(t), **kw)
        return make_mesh(n_gop=int(s), n_tile=1, **kw)
    raise TypeError(f'unsupported mesh spec: {spec!r}')

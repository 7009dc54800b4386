"""Streams that force the decoder off the batch path.

An escape-coded ZERO level dequantizes to +1 in the reference (the oddify
step of src/mpeg1.js:793-810), which the levels wire cannot express: a
zero in the dense lattice is an uncoded position.  The batch parser flags
such a picture and the decoder finishes on the always-exact serial path.
"""

from __future__ import annotations

import numpy as np

from .. import tables as T
from .gen import _intra_levels, _pad_plane, make_ycbcr_frame
from .mpeg1_enc import MB, MPEG1Encoder


class EscapeZeroEncoder(MPEG1Encoder):
    """Emits an escape-coded ZERO level (double-byte form) at zig-zag
    position `zero_pos` of the next non-intra block after `_armed` is
    set."""

    def __init__(self, *a, zero_pos=2, **kw):
        super().__init__(*a, **kw)
        self.zero_pos = zero_pos
        self._armed = False

    def _encode_nonintra_block(self, levels):
        if self._armed:
            self._armed = False
            w = self.w
            w.write_bits(T.DCT_COEFF_ESCAPE)
            w.write(self.zero_pos, 6)      # run (first coeff: run==position)
            w.write(0, 8)                  # escape marker byte
            w.write(0, 8)                  # level == 0
            # then a normal trailing coefficient and EOB
            lv = np.asarray(levels, dtype=np.int64)
            self._encode_ac(lv, start=self.zero_pos + 1, first_coeff=False)
            w.write_bits('10')
            return
        super()._encode_nonintra_block(levels)


def escape_zero_stream(w: int = 48, h: int = 32) -> bytes:
    """An I picture, then a P picture whose first macroblock carries the
    escape-coded zero (every other macroblock copies the reference)."""
    enc = EscapeZeroEncoder(w, h, qscale=8, f_code=1, zero_pos=2)
    mb_w, mb_h = enc.mb_w, enc.mb_h
    cw, ch = mb_w * 16, mb_h * 16
    y, cb, cr = make_ycbcr_frame(w, h, 0, seed=0)
    y = _pad_plane(y, ch, cw)
    cb = _pad_plane(cb, ch >> 1, cw >> 1)
    cr = _pad_plane(cr, ch >> 1, cw >> 1)

    enc.sequence_header()
    mbs = [MB('intra', levels=_intra_levels(y, cb, cr, r, c, 8, enc.intra_q))
           for r in range(mb_h) for c in range(mb_w)]
    enc.encode_picture(T.PIC_I, mbs)

    trailing = np.zeros(64, dtype=np.int64)
    trailing[10] = 7
    zeros = np.zeros(64, dtype=np.int64)
    mbs = []
    for i in range(mb_h * mb_w):
        if i == 0:
            enc._armed = True
            mbs.append(MB('mc_coded', mv=(0, 0),
                          levels=[trailing] + [zeros.copy()] * 5))
        else:
            mbs.append(MB('mc', mv=(0, 0)))
    enc.encode_picture(T.PIC_P, mbs)
    enc.sequence_end()
    return enc.getvalue()

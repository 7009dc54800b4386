"""jsmpeg_tpu_torch: the PyTorch/CUDA port of jsmpeg_tpu.

Decodes MPEG-TS / MPEG1 video bit-exactly on an NVIDIA H100: the C++ host
frontend parses the bitstream, and hand-written CUDA kernels (csrc/) do
the dequant + IDCT and the per-frame motion compensation + combine.  The
JAX package jsmpeg_tpu is the reference it is tested against.

Importing the package has no side effects: kernels build at their first
CUDA use, the host library at its first parser.
"""

__version__ = '0.1.0'

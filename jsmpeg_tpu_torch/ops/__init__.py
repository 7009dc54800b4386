"""Device stages: dequant + IDCT (idct.py, kernel K1), motion
compensation (motion.py) and the frame step (frame.py, kernel K2), with
the kernels' build and bindings in kernels.py."""

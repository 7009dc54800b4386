"""Decoders: MPEG1 video (mpeg1.py)."""

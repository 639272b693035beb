"""Pileup feature construction: read event extraction, channel-count images,
candidate selection, and window tensor assembly (TPU-vectorized redesign of
src/create_tensor_pileup.py)."""

"""Device compute: the tilelet expansion kernel and the fused chunk pass."""

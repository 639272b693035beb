"""Pileup genotyping network (PyTorch) + weight I/O and TF conversion."""

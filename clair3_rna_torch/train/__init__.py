"""Model training: tensor binning, focal-loss training loop, RAdam."""

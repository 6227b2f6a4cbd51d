"""Tensor ops of the port: deformable sampling, heatmap decoding, cameras."""

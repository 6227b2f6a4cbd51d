"""Ego4View datasets, the batched loader and the synthetic tree."""

"""Inputs made from the seed: thorax meshes and training phantoms."""

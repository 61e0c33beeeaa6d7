"""Mesh-bound Gaussians and the refinement trainer."""

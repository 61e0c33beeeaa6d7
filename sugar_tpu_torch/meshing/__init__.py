"""Coarse mesh extraction: level set, Poisson, QEM decimation, ablations."""

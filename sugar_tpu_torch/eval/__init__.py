"""Evaluation: image metrics and the quality-parity scene."""

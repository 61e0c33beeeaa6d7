"""Trainers of the port: the vanilla 3DGS stage, its Adam and schedules."""

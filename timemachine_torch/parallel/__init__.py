"""Replica-parallel samplers."""

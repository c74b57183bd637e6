"""Test systems."""

"""Systems and model utilities."""

"""MD: Context, barostat, FIRE and helpers."""

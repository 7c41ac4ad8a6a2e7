"""Device-side data helpers."""

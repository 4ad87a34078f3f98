"""Device resolution and numeric-precision helpers."""

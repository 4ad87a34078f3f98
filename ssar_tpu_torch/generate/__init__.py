"""Audio-to-video serve path."""

"""Host-side utilities: logging, thread helpers, device selection, stats."""

"""Runtime services: logging."""

"""Model drivers."""

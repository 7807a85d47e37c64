"""Model packaging."""

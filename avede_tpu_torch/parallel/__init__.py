"""The frame-embedding engine."""

"""Configuration, logging, errors, device resolution."""

"""Phase-1 text→video scan."""

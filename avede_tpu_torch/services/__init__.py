"""Query rewrite and the processing facade."""

"""Published configurations the port runs (the paper's own first)."""

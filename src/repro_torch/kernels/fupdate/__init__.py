"""fupdate: f + k(X, X_sel) @ delta, the SMO hot-loop update."""

"""Caption post-processing; the metrics wait for their own slice."""

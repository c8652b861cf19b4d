"""Run-directory helpers: logs, TensorBoard events, the model summary."""

"""Training: losses, the optimizer chain, the train state, the steps and
the Trainer."""

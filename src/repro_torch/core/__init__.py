"""LP plans and the retraining-free merge."""

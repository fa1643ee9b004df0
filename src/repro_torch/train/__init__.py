"""Training: optimizer, step, fault-tolerant loop."""

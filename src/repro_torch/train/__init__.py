"""Training: state, step and loop."""

"""Training: state, the two-group fused Adam, the train step, the loop."""

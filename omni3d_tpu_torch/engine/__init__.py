"""Engine: the training losses and the single-device training step."""

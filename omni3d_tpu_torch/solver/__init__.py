"""Solver: optimizer parameter groups and the WarmupMultiStepLR schedule."""

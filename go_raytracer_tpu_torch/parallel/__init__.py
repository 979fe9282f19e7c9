"""Scene parameters and the differentiable training step."""

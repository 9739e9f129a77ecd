"""Entry points that serve the model zoo."""

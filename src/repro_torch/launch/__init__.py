"""Entry points that serve and train the model zoo, and its roofline."""

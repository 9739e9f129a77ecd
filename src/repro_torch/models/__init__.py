"""The paper's §2.4 CNN and the model zoo's layers, stack and decode in
PyTorch."""

"""The paper's §2.4 CNN in PyTorch."""

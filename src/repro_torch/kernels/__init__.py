"""Hand-written Hopper kernels, their plain PyTorch versions and the
build that compiles them (`build.py`)."""
